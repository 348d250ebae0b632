#!/usr/bin/env bash
# view (or render) a trained caladium (141-band Bayspec) run: the PyTorch/CUDA
# port's twin of scripts/visualize/caladium.sh, the same command with
# umhs_torch for umhs_tpu, flag for flag. It runs on one NVIDIA card (add
# --device cpu for the CPU). Supply a trained caladium run at
# outputs/caladium-t0.7-k4 (caladium.sh names its run caladium-t0.5-k5: point
# --load-config at the run you trained) and, for the commented render, a
# camera path; it is not in the repository.
python -m umhs_torch.cli.viewer \
 --load-config "outputs/caladium-t0.7-k4/umhsnerf/config.yml"
# offline camera-path render (reference's commented ns-render line):
# python -m umhs_torch.cli.render camera-path \
#  --load-config "outputs/caladium-t0.7-k4/umhsnerf/config.yml" \
#  --camera-path-filename data/caladium/camera_paths/path.json \
#  --output-path renders/caladium.mp4
