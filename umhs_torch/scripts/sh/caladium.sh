#!/usr/bin/env bash
# caladium (141-band Bayspec capture): the PyTorch/CUDA port's twin of
# scripts/caladium.sh, the same command with umhs_torch for umhs_tpu, flag for
# flag. It runs on one NVIDIA card (add --device cpu for the CPU). Supply
# data/hsnerf/bayspec/caladium/processed_dataset, the processed Bayspec
# capture; it is not in the repository.
python -m umhs_torch.cli.train umhsnerf \
 --machine.seed 42 --pipeline.num_classes 5 \
 --pipeline.model.far-plane 1000 --pipeline.model.near_plane 0.05 \
 --pipeline.model.background-color black \
 --pipeline.model.spectral_loss_weight 5.0 --pipeline.model.temperature 0.5 \
 --pipeline.model.pred_specular True --pipeline.model.load_vca True \
 --pipeline.datamanager.train-num-rays-per-batch 2048 \
 --pipeline.datamanager.eval-num-rays-per-batch 256 \
 --pipeline.datamanager.hs-dtype bfloat16 \
 --pipeline.model.method rgb+spectral \
 --data data/hsnerf/bayspec/caladium/processed_dataset \
 --experiment-name "caladium-t0.5-k5" --vis console
