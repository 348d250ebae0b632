#!/usr/bin/env bash
# camera-path render of the hotdog run: the PyTorch/CUDA port's twin of
# scripts/render.sh, the same command with umhs_torch for umhs_tpu, flag for
# flag. It runs on one NVIDIA card (add --device cpu for the CPU). Supply the
# run hotdog.sh trains (outputs/hotdog-t0.4-k6-specular) and the camera path
# data/processed/hotdog/camera_paths/hotdog.json; it is not in the repository.
# Without imageio the frames are written as PNGs beside the .mp4 path.
python -m umhs_torch.cli.render camera-path \
 --load-config "outputs/hotdog-t0.4-k6-specular/umhsnerf/config.yml" \
 --camera-path-filename "data/processed/hotdog/camera_paths/hotdog.json" \
 --output-path renders/hotdog/hotdog.mp4 \
 --rendered-output-names "rgb" "abundances_0" "abundances_1" "abundances_2" "abundances_3" "abundances_4" "abundances_5"
