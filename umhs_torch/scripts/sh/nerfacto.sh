#!/usr/bin/env bash
# nerfacto-style RGB baseline, the rgb method with the proposal sampler: the
# PyTorch/CUDA port's twin of scripts/nerfacto.sh, the same command with
# umhs_torch for umhs_tpu, flag for flag. It runs on one NVIDIA card (add
# --device cpu for the CPU). Supply data/processed/hotdog, the processed
# hotdog scene; it is not in the repository.
python -m umhs_torch.cli.train umhsnerf \
 --machine.seed 42 \
 --pipeline.model.method rgb \
 --pipeline.model.sampler proposal \
 --pipeline.datamanager.train-num-rays-per-batch 8192 \
 --data data/processed/hotdog \
 --experiment-name nerfacto-baseline --vis console
