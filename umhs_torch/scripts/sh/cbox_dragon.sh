#!/usr/bin/env bash
# cbox_dragon Cornell-box spectral scene: the PyTorch/CUDA port's twin of
# scripts/cbox_dragon.sh, the same command with umhs_torch for umhs_tpu, flag
# for flag. It runs on one NVIDIA card (add --device cpu for the CPU). Supply
# data/processed/cbox_dragon, the processed scene; it is not in the
# repository.
python -m umhs_torch.cli.train umhsnerf \
 --steps_per_save 1000 --machine.seed 42 \
 --pipeline.num_classes 5 \
 --pipeline.model.far-plane 1000 --pipeline.model.near_plane 0.05 \
 --pipeline.model.background-color random \
 --pipeline.model.spectral_loss_weight 5.0 --pipeline.model.temperature 0.4 \
 --pipeline.model.pred_specular True --pipeline.model.load_vca True \
 --pipeline.datamanager.train-num-rays-per-batch 4096 \
 --pipeline.model.method rgb+spectral \
 --data data/processed/cbox_dragon --experiment-name cbox_dragon \
 --vis console
