#!/usr/bin/env bash
# view a trained anacampseros (141-band Bayspec) run: the PyTorch/CUDA port's
# twin of scripts/visualize/anacampseros.sh, the same command with umhs_torch
# for umhs_tpu, flag for flag. It runs on one NVIDIA card (add --device cpu
# for the CPU). Supply a trained anacampseros run at
# outputs/anacampseros-t0.7-k4; it is not in the repository.
python -m umhs_torch.cli.viewer \
 --load-config "outputs/anacampseros-t0.7-k4/umhsnerf/config.yml"
