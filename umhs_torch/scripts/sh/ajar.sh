#!/usr/bin/env bash
# ajar (NeSpoF scene, 7 classes): the PyTorch/CUDA port's twin of
# scripts/ajar.sh, the same command with umhs_torch for umhs_tpu, flag for
# flag. It runs on one NVIDIA card (add --device cpu for the CPU). Supply
# data/processed/ajar, the processed NeSpoF ajar scene; it is not in the
# repository.
python -m umhs_torch.cli.train umhsnerf --steps_per_save 1000 \
 --save_only_latest_checkpoint False \
 --machine.seed 42 --log-gradients True \
 --pipeline.num_classes 7 --pipeline.model.far-plane 1000 \
 --pipeline.model.near_plane 0.05 --pipeline.model.background-color random \
 --pipeline.model.spectral_loss_weight 5.0 --pipeline.model.temperature 0.4 \
 --pipeline.model.pred_dino False --pipeline.model.pred_specular False \
 --pipeline.model.load_vca True \
 --pipeline.datamanager.train-num-rays-per-batch 2048 \
 --pipeline.model.method rgb+spectral --data data/processed/ajar \
 --experiment-name ajar-t0.4-kfinal --vis console
