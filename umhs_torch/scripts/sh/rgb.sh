#!/usr/bin/env bash
# rgb-only baseline: the PyTorch/CUDA port's twin of scripts/rgb.sh, the same
# command with umhs_torch for umhs_tpu, flag for flag. It runs on one NVIDIA
# card (add --device cpu for the CPU). Supply data/processed/ajar, the
# processed NeSpoF ajar scene; it is not in the repository.
python -m umhs_torch.cli.train umhsnerf \
 --machine.seed 42 \
 --log-gradients True \
 --pipeline.model.far-plane 1000 \
 --pipeline.model.near_plane 0.05 \
 --pipeline.model.background-color random \
 --pipeline.datamanager.train-num-rays-per-batch 8192 \
 --pipeline.model.method rgb \
 --data data/processed/ajar \
 --experiment-name rgb \
 --vis console
