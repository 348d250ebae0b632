#!/usr/bin/env bash
# view (or evaluate) a trained ajar run: the PyTorch/CUDA port's twin of
# scripts/visualize/ajar.sh, the same command with umhs_torch for umhs_tpu,
# flag for flag. It runs on one NVIDIA card (add --device cpu for the CPU).
# Supply a trained ajar run at outputs/ajar-t0.4-k7 (ajar.sh names its run
# ajar-t0.4-kfinal: point --load-config at the run you trained); it is not in
# the repository.
python -m umhs_torch.cli.viewer \
 --load-config "outputs/ajar-t0.4-k7/umhsnerf/config.yml"
# offline metrics over the eval split:
# python -m umhs_torch.cli.eval \
#  --load-config "outputs/ajar-t0.4-k7/umhsnerf/config.yml" \
#  --output-path eval/ajar_metrics.json
