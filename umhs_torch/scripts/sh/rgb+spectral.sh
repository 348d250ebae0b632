#!/usr/bin/env bash
# joint rgb+spectral supervision with gradient accumulation: the PyTorch/CUDA
# port's twin of scripts/rgb+spectral.sh, the same command with umhs_torch for
# umhs_tpu, flag for flag. It runs on one NVIDIA card (add --device cpu for
# the CPU). Supply data/processed/ajar, the processed NeSpoF ajar scene; it is
# not in the repository. --gradient-accumulation_steps 3 averages three
# batches' gradients before each Adam step (engine/trainer.py MultiStepAdam,
# optax.MultiSteps' rule).
python -m umhs_torch.cli.train umhsnerf \
 --machine.seed 42 --gradient-accumulation_steps 3 \
 --pipeline.model.far-plane 1000 --pipeline.model.near_plane 0.05 \
 --pipeline.model.background-color random \
 --pipeline.model.spectral_loss_weight 5.0 --pipeline.model.temperature 0.4 \
 --pipeline.model.pred_specular True --pipeline.model.load_vca True \
 --pipeline.datamanager.train-num-rays-per-batch 2048 \
 --pipeline.model.method rgb+spectral --data data/processed/ajar \
 --experiment-name "rgb+spectral" --vis console
