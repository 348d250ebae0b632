#!/usr/bin/env bash
# evaluate a trained hotdog run: the PyTorch/CUDA port's twin of
# scripts/visualize/hotdog.sh, the same command with umhs_torch for umhs_tpu,
# flag for flag. It runs on one NVIDIA card (add --device cpu for the CPU).
# Supply the run hotdog.sh trains (outputs/hotdog-t0.4-k6-specular); it is not
# in the repository.
python -m umhs_torch.cli.eval \
 --load-config "outputs/hotdog-t0.4-k6-specular/umhsnerf/config.yml" \
 --output-path eval/hotdog_metrics.json
