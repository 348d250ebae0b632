#!/usr/bin/env bash
# spectral-only run: the PyTorch/CUDA port's twin of scripts/spectral.sh, the
# same command with umhs_torch for umhs_tpu, flag for flag. It runs on one
# NVIDIA card (add --device cpu for the CPU). Supply data/processed/ajar, the
# processed NeSpoF ajar scene; it is not in the repository.
python -m umhs_torch.cli.train umhsnerf \
 --machine.seed 42 \
 --log-gradients True \
 --pipeline.model.far-plane 1000 \
 --pipeline.model.near_plane 0.05 \
 --pipeline.model.background-color last_sample \
 --pipeline.datamanager.train-num-rays-per-batch 8192 \
 --pipeline.model.method spectral \
 --data data/processed/ajar \
 --experiment-name "spectral only try" \
 --vis console
