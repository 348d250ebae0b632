"""UMHS model: NeRF with spectral unmixing (port of umhs_tpu/models/model.py).

`UMHSModel` is a static descriptor (configs and colour system); parameters,
occupancy state and rays are arguments. Two samplers, as in the JAX model:

- "occgrid" (the reference method's): the forward marches the rays through
  the occupancy grid, gathers the valid samples into a compact buffer (in
  stages with an exact transmittance check between them when per-stage
  budgets are given), runs the field there, composites weights, accumulates
  spectra, abundances, depth and opacity per ray, projects the spectrum to
  RGB and segments it against the endmembers.
- "proposal" (nerfacto's, scripts/nerfacto.sh): uniform s-space bins, a
  chain of proposal density nets with PDF resampling, then the main field
  on the padded (R, num_nerf_samples) block; no occupancy grid.

With pred_dino (spectral methods) the DINO head's features are accumulated
with detached weights and probed against the learnable `dino_clusters`.

The training side: `forward(train=True, t_jitter=...)` marches with a
per-ray start jitter and looks up the train appearance vector (the proposal
sampler takes its stratification jitters as `prop_jitter`); `loss` takes its
random background and the step as arguments; `metrics`, `post_step`
(endmember clamp), `occ_update_due` and `update_occupancy(full=...)` mirror
the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops.compact import compact_stage, gather_lanes
from ..ops.compositing import (
    accumulate,
    compact_accumulate_stages,
    render_accumulation,
    render_depth_expected,
    render_weights,
)
from ..ops.encodings import HashEncodingConfig
from ..ops.proposal_sampling import (
    distortion_loss,
    interlevel_loss,
    pdf_resample,
    sdist_to_t,
    uniform_bins,
)
from ..ops.occupancy import (
    OccGridConfig,
    init_occ_state,
    occ_update_due,
    update_occ_state,
)
from ..ops.ray_marching import MarchConfig, march_rays, sample_positions
from ..ops.spec_to_rgb import ColourSystem
from ..utils.clusterprobe import cluster_probe, label_to_rgb
from .field import (
    FieldConfig,
    clamp_endmembers,
    density_fn,
    field_density,
    field_outputs,
    init_field_params,
    init_proposal_params,
    proposal_density,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """umhs_tpu's ModelConfig, same defaults (less the TPU's gather layout
    of the dense hash levels), plus the port's `impl`."""

    method: str = "rgb"  # rgb | spectral | rgb+spectral
    grid_resolution: int = 128
    grid_levels: int = 4
    max_res: int = 2048
    log2_hashmap_size: int = 19
    hash_num_levels: int = 16
    hash_features_per_level: int = 2
    hash_interpolation: str = "trilinear"
    alpha_thre: float = 0.01
    cone_angle: float = 0.004
    render_step_size: Optional[float] = None
    near_plane: float = 0.05
    far_plane: float = 1.0e3
    use_gradient_scaling: bool = True
    background_color: str = "random"  # random | black | white | last_sample
    disable_scene_contraction: bool = False
    rgb_loss_weight: float = 1.0
    spectral_loss_weight: float = 5.0
    temperature: float = 0.2
    pred_dino: bool = False
    pred_specular: bool = False
    specular_ramp_steps: int = 1000
    load_vca: bool = False  # setup() reads the dataset's vca.npy endmembers
    eval_num_rays_per_chunk: int = 4096
    num_candidates: int = 1024
    max_samples_per_ray: int = 96
    occ_subsamples: int = 4
    occ_warmup_full_every: int = 1
    march_pool: int = 4
    early_stop_eps: float = 1e-4
    march_early_stop_od: float = 0.0
    march_early_stop_warmup: int = 512
    compute_dtype: str = "float32"  # or "bfloat16"
    stochastic_hash_grad: bool = True  # one-vertex gradient splatting
    compact_samples: bool = True
    compact_fraction: float = 0.5
    stage_samples: int = 16
    stage_boundaries: Tuple[int, ...] = (8, 16)
    # "occgrid" (occupancy marching) or "proposal" (nerfacto's proposal
    # nets with PDF resampling; no occupancy grid)
    sampler: str = "occgrid"
    num_proposal_samples: Tuple[int, ...] = (256, 96)
    num_nerf_samples: int = 48
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    # "auto": hand-written kernels on CUDA tensors, plain versions on CPU;
    # "plain": plain versions everywhere (to hold the kernels against them)
    impl: str = "auto"


def _grad_scale(x: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """Identity forward (as the JAX package rounds it), gradient scaled."""
    return x * scaling + (x * (1.0 - scaling)).detach()


class UMHSModel:
    """Static model descriptor; all state flows through arguments."""

    def __init__(
        self,
        config: ModelConfig,
        wavelengths: Sequence[float],
        num_classes: int,
        num_images: int,
        scene_scale: float = 1.0,
        device="cuda",
    ):
        self.config = config
        self.device = resolve_device(device)
        self.wavelengths = list(wavelengths) if wavelengths is not None else []
        self.num_classes = num_classes
        self.num_images = num_images
        aabb_min = (-scene_scale,) * 3
        aabb_max = (scene_scale,) * 3
        if config.render_step_size is None:
            render_step_size = float(np.linalg.norm(np.subtract(aabb_max, aabb_min))) / 1000.0
        else:
            render_step_size = config.render_step_size
        self.render_step_size = render_step_size

        pool = config.march_pool
        if pool > 1 and config.grid_resolution % pool != 0:
            pool = 0
        self.occ_config = OccGridConfig(
            resolution=config.grid_resolution,
            levels=config.grid_levels,
            aabb_min=aabb_min,
            aabb_max=aabb_max,
            pool=pool,
            warmup_full_every=config.occ_warmup_full_every,
        )
        self.march_config = MarchConfig(
            num_candidates=config.num_candidates,
            num_samples=config.max_samples_per_ray,
            render_step_size=render_step_size,
            cone_angle=config.cone_angle,
            near_plane=config.near_plane,
            far_plane=config.far_plane,
            occ_subsamples=config.occ_subsamples,
            pool=pool,
            early_stop_od=config.march_early_stop_od,
        )
        self.field_config = FieldConfig(
            method=config.method,
            num_classes=num_classes,
            num_bands=len(self.wavelengths) if "spectral" in config.method else 0,
            num_images=num_images,
            temperature=config.temperature,
            pred_specular=config.pred_specular,
            specular_ramp_steps=config.specular_ramp_steps,
            pred_dino=config.pred_dino,
            use_scene_contraction=not config.disable_scene_contraction,
            aabb_min=aabb_min,
            aabb_max=aabb_max,
            hash=HashEncodingConfig(
                num_levels=config.hash_num_levels,
                features_per_level=config.hash_features_per_level,
                log2_hashmap_size=config.log2_hashmap_size,
                max_resolution=config.max_res,
                interpolation=config.hash_interpolation,
                stochastic_grad=config.stochastic_hash_grad,
            ),
            compute_dtype=(torch.bfloat16 if config.compute_dtype == "bfloat16"
                           else torch.float32),
            impl=config.impl,
        )
        self.converter = (
            ColourSystem(self.wavelengths, device=self.device) if self.wavelengths else None
        )
        # the proposal nets' grids (nerfacto's: 5 levels, exact backward)
        self.proposal_hash_configs = (
            HashEncodingConfig(num_levels=5, max_resolution=128, log2_hashmap_size=17,
                               base_resolution=16),
            HashEncodingConfig(num_levels=5, max_resolution=256, log2_hashmap_size=17,
                               base_resolution=16),
        )

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, endmembers_init: Optional[np.ndarray] = None):
        """(params, empty occupancy state) on the model's device; with the
        proposal sampler, "proposal_i" drawn after the field's parameters."""
        params = init_field_params(generator, self.field_config, endmembers_init, self.device)
        if self.config.sampler == "proposal":
            n = len(self.config.num_proposal_samples)
            for i, hcfg in enumerate(self.proposal_hash_configs[:n]):
                params[f"proposal_{i}"] = init_proposal_params(generator, hcfg,
                                                               device=self.device)
        return params, init_occ_state(self.occ_config, self.device)

    def update_occupancy(self, occ_state, params, jitter: torch.Tensor, full: bool = True,
                         cell_draws=None):
        """Occupancy EMA update with the given jitter: full (jitter
        (levels * res^3, 3)), or partial at the cells `partial_cells`'
        rule chooses from `cell_draws` (jitter (M, 3)). On the card a
        partial update takes occ_state's grids over (`update_occ_state`):
        the caller replaces its state with the result and uses the old one
        no more, as the trainer does."""
        return update_occ_state(
            occ_state, self.occ_config, density_fn(params, self.field_config),
            self.render_step_size, jitter, impl=self.config.impl,
            draws=None if full else cell_draws,
        )

    def occ_update_due(self, step: int) -> Tuple[bool, bool]:
        """(due, full) at `step` (nerfacc's schedule with warmup thinning);
        never with the proposal sampler."""
        if self.config.sampler == "proposal":
            return False, False
        return occ_update_due(step, self.occ_config)

    @staticmethod
    def post_step(params):
        """After each optimizer step: clamp the endmembers to [0, 1]."""
        return clamp_endmembers(params)

    def _compact_budget(self, num_rays: int, num_samples: int) -> int:
        """Compact-buffer size, 256-aligned."""
        b = int(num_rays * num_samples * self.config.compact_fraction)
        return max(256, (b // 256) * 256)

    def active_stage_boundaries(self, num_samples: int) -> Tuple[int, ...]:
        """Staged-termination lane boundaries for a per-ray sample count."""
        cfg = self.config
        bounds = tuple(cfg.stage_boundaries) or (
            (cfg.stage_samples,) if cfg.stage_samples > 0 else ()
        )
        return tuple(sorted({b for b in bounds if 0 < b < num_samples}))

    # ------------------------------------------------------------------
    def forward(
        self,
        params,
        occ_state: Dict[str, torch.Tensor],
        rays: Dict[str, torch.Tensor],
        compact_budget: Optional[Union[int, Sequence[int]]] = None,
        step: Optional[int] = None,
        train: bool = False,
        t_jitter: Optional[torch.Tensor] = None,
        march_config: Optional[MarchConfig] = None,
        prop_jitter: Optional[Sequence[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render rays {"origins", "directions" (R, 3), "camera_indices" (R,)}.

        train=False is the eval forward (deterministic march, eval
        appearance vector); train=True marches with each ray's start shifted
        by t_jitter (R,) in [0, 1) times the step size (the JAX package draws
        it as uniform(k_march, (R,))) and looks up the train appearance
        vector of each ray's camera.

        compact_budget: one budget (single-stage compact evaluation), or one
        per stage of active_stage_boundaries(S) (staged evaluation with an
        exact transmittance check after each stage). Default: one budget of
        compact_fraction * R * S. step gates the specular warmup ramp.
        march_config overrides the model's march (the trainer's adapted
        samples per ray S).

        The proposal sampler ignores occ_state, compact_budget, t_jitter and
        march_config: see `_forward_proposal`.
        """
        cfg = self.config
        if cfg.sampler == "proposal":
            return self._forward_proposal(params, rays, prop_jitter, train=train, step=step)
        march_cfg = march_config or self.march_config
        # nerfacc semantics: alpha threshold min(alpha_thre, mean occupancy)
        alpha_thre = torch.clamp_max(torch.mean(occ_state["occs"]), cfg.alpha_thre)
        o, d = rays["origins"], rays["directions"]
        cam_idx = rays.get("camera_indices")
        if cam_idx is None:
            cam_idx = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
        R = o.shape[0]
        S = march_cfg.num_samples
        compact = cfg.compact_samples
        B = compact_budget or self._compact_budget(R, S)
        multi = isinstance(B, (tuple, list))
        od_val = None  # od culling is off while the EMA grid warms up
        if step is not None and cfg.march_early_stop_od > 0.0:
            od_val = (cfg.march_early_stop_od if step >= cfg.march_early_stop_warmup
                      else float("inf"))
        march = march_rays(
            occ_state, self.occ_config, march_cfg, o, d,
            t_jitter=t_jitter if train else None,
            total_budget=(sum(B) if multi else B) if compact else None,
            early_stop_od_value=od_val, impl=cfg.impl,
        )
        t_starts, t_ends, mask = march["t_starts"], march["t_ends"], march["mask"]
        d_unit = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        positions = sample_positions(o, d, t_starts, t_ends)  # (R, S, 3)
        fc = self.field_config

        if compact:
            bounds = self.active_stage_boundaries(S)
            if multi and bounds and len(B) == len(bounds) + 1:
                stage_budgets = [int(b) for b in B]
                edges = (0,) + bounds + (S,)
                lane_splits = list(zip(edges[:-1], edges[1:]))
            else:
                stage_budgets = [sum(B) if multi else int(B)]
                lane_splits = [(0, S)]

            stage_data = []
            density_parts, mask_parts = [], []
            tmid = (t_starts + t_ends) / 2.0
            live_rays = None  # (R,) bool: transmittance still above early_stop_eps
            od_prev = None
            for (lo, hi), Bs in zip(lane_splits, stage_budgets):
                L = hi - lo
                # K6a: the slot map, src (the lane of each row), counts, starts
                comp = compact_stage(mask[:, lo:hi], live_rays, Bs, impl=cfg.impl)
                m, src = comp.mask, comp.src

                pos_c = positions[:, lo:hi].reshape(-1, 3)[src]
                ray_id = src // L
                density_c, geo_c = field_density(params, fc, pos_c)
                heads_c = field_outputs(params, fc, pos_c, d_unit[ray_id], cam_idx[ray_id],
                                        geo_c, train=train, step=step)
                if cfg.use_gradient_scaling:
                    scaling_c = torch.clamp(tmid[:, lo:hi].reshape(-1)[src] ** 2, 0.0, 1.0)
                    density_c = _grad_scale(density_c, scaling_c)
                    heads_c = {k: _grad_scale(v, scaling_c[..., None]) for k, v in heads_c.items()}

                # K6b: densities back in the (R, L) layout through the slot map
                density_l = gather_lanes(density_c, comp, impl=cfg.impl)
                density_parts.append(density_l)
                mask_parts.append(m)
                stage_data.append({"comp": comp, "heads": heads_c, "lo": lo, "hi": hi})

                if hi < S:
                    # exact transmittance after this stage, with the
                    # alpha_thre filter render_weights applies
                    delta = torch.clamp_min(t_ends[:, lo:hi] - t_starts[:, lo:hi], 0.0)
                    sd = torch.where(m, density_l * delta, torch.zeros_like(delta))
                    al = 1.0 - torch.exp(-sd)
                    od_stage = torch.where(al >= alpha_thre, sd, torch.zeros_like(sd)).sum(-1)
                    od_prev = (od_stage if od_prev is None else od_stage + od_prev).detach()
                    live_rays = od_prev < float(-np.log(max(cfg.early_stop_eps, 1e-30)))

            mask = torch.cat(mask_parts, dim=1)
            weights = render_weights(t_starts, t_ends, torch.cat(density_parts, dim=1), mask,
                                     alpha_thre=alpha_thre, early_stop_eps=cfg.early_stop_eps,
                                     impl=cfg.impl)

            def accumulate_fn(key, w=weights):
                # K6d: every stage's rows of the head, their weights gathered
                # through src, the stage sums added in stage order
                return compact_accumulate_stages(
                    w, [(sd_["lo"], sd_["hi"], sd_["heads"][key], sd_["comp"])
                        for sd_ in stage_data], impl=cfg.impl)

            def accumulate_sg(key):
                # detached weights, values with their gradient (the DINO head)
                return accumulate_fn(key, weights.detach())

            num_eval_stages = [mp.sum(dim=-1, dtype=torch.int32) for mp in mask_parts]
        else:
            flat_pos = positions.reshape(-1, 3)
            density, geo_feat = field_density(params, fc, flat_pos)
            density = density.reshape(R, S)
            flat_dirs = d_unit[:, None, :].expand(R, S, 3).reshape(-1, 3)
            flat_cam = cam_idx[:, None].expand(R, S).reshape(-1)
            heads = field_outputs(params, fc, flat_pos, flat_dirs, flat_cam, geo_feat,
                                  train=train, step=step)
            heads = {k: v.reshape(R, S, -1) for k, v in heads.items()}
            if cfg.use_gradient_scaling:
                scaling = torch.clamp(((t_starts + t_ends) / 2.0) ** 2, 0.0, 1.0)
                density = _grad_scale(density, scaling)
                heads = {k: _grad_scale(v, scaling[..., None]) for k, v in heads.items()}
            weights = render_weights(t_starts, t_ends, density, mask,
                                     alpha_thre=alpha_thre, early_stop_eps=cfg.early_stop_eps,
                                     impl=cfg.impl)

            def accumulate_fn(key):
                return accumulate(weights, heads[key])

            def accumulate_sg(key):
                return accumulate(weights.detach(), heads[key])

            num_eval_stages = [mask.sum(dim=-1, dtype=torch.int32)]

        outputs: Dict[str, torch.Tensor] = {
            "accumulation": render_accumulation(weights),
            "depth": render_depth_expected(weights, t_starts, t_ends, mask),
            "num_samples_per_ray": march["num_samples"],
            "num_occupied_per_ray": march["num_occupied"],
            "num_eval_s1_per_ray": num_eval_stages[0],
            "num_eval_s2_per_ray": (num_eval_stages[1] if len(num_eval_stages) > 1
                                    else torch.zeros_like(num_eval_stages[0])),
        }
        for i, ne in enumerate(num_eval_stages[2:], start=3):
            outputs[f"num_eval_s{i}_per_ray"] = ne
        self._ray_outputs(params, outputs, accumulate_fn, accumulate_sg)
        return outputs

    def _ray_outputs(self, params, outputs: Dict[str, torch.Tensor], accumulate_fn,
                     accumulate_sg) -> None:
        """The per-ray heads into `outputs` (which holds the accumulation):
        rgb, or the spectrum, its RGB projection, abundances and the
        segmentation, and with pred_dino the DINO features (accumulated with
        detached weights) and their probe against dino_clusters."""
        cfg = self.config
        if cfg.method == "rgb":
            outputs["rgb"] = accumulate_fn("rgb")
        if "spectral" not in cfg.method:
            return
        spectral = accumulate_fn("spectral")
        outputs["spectral"] = spectral
        if cfg.pred_specular:
            outputs["spectral2"] = accumulate_fn("spectral2")
            outputs["specular"] = accumulate_fn("specular").detach()
        rgb = self.converter(spectral)
        outputs["rgb"] = rgb.detach() if cfg.method == "spectral" else rgb
        outputs["abundances"] = accumulate_fn("abundances").detach()
        # unsupervised material segmentation against the endmembers
        _, cluster_probs = cluster_probe(spectral, params["endmembers"], alpha=0.2)
        acc_if = (outputs["accumulation"] > 0.5).float()
        labels = torch.argmax(cluster_probs, dim=1)
        outputs["seg_probs"] = cluster_probs
        outputs["seg_raw"] = (labels.float() * acc_if[:, 0]).detach()
        outputs["seg_pred"] = (label_to_rgb(labels) * acc_if).detach()
        if cfg.pred_dino:
            outputs["dino"] = accumulate_sg("dino")
            # with detached features and one-hot probabilities the cluster
            # loss moves the centres only (a spherical k-means step)
            ip, probs = cluster_probe(outputs["dino"].detach(), params["dino_clusters"],
                                      alpha=None)
            outputs["cluster_probs"] = probs
            outputs["inner_products"] = ip

    def _forward_proposal(
        self,
        params,
        rays: Dict[str, torch.Tensor],
        prop_jitter: Optional[Sequence[torch.Tensor]] = None,
        train: bool = False,
        step: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """nerfacto's forward (umhs_tpu/models/model.py:651-778): uniform
        s-bins, each proposal net's weights on them and PDF resampling to the
        next count, then the main field on the final bins (every lane valid).
        Bins live in s-space, warped to t between near_plane and far_plane.

        prop_jitter: len(num_proposal_samples) + 1 tensors (R, 1) of uniform
        [0, 1) draws (a (P + 1, R, 1) tensor will do), the JAX package's
        uniform(k_i, (R, 1)) for the keys split from its forward's key: the
        first for the uniform bins, then one per resampling; None for none.
        train=True adds the proposal supervision's histograms (prop_edges_i,
        prop_weights_i, final_edges, final_weights) to the outputs."""
        cfg = self.config
        fc = self.field_config
        o, d = rays["origins"], rays["directions"]
        d_unit = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        cam_idx = rays.get("camera_indices")
        if cam_idx is None:
            cam_idx = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
        R = o.shape[0]
        near, far = cfg.near_plane, cfg.far_plane
        jitters = (list(prop_jitter) if prop_jitter is not None
                   else [None] * (len(cfg.num_proposal_samples) + 1))
        if len(jitters) != len(cfg.num_proposal_samples) + 1:
            raise ValueError(f"prop_jitter: {len(jitters)} draws for "
                             f"{len(cfg.num_proposal_samples)} proposal levels")

        def positions_of(s_edges):
            t_edges = sdist_to_t(s_edges, near, far)
            t_lo, t_hi = t_edges[:, :-1], t_edges[:, 1:]
            return t_lo, t_hi, o[:, None, :] + d_unit[:, None, :] * ((t_lo + t_hi) / 2.0)[..., None]

        aux_edges, aux_weights = [], []
        s_edges = uniform_bins(R, cfg.num_proposal_samples[0], jitters[0], device=o.device)
        counts = list(cfg.num_proposal_samples[1:]) + [cfg.num_nerf_samples]
        for i, n_next in enumerate(counts):
            t_lo, t_hi, pos = positions_of(s_edges)
            sigma = proposal_density(params[f"proposal_{i}"], self.proposal_hash_configs[i], fc,
                                     pos.reshape(-1, 3)).reshape(t_lo.shape)
            w = render_weights(t_lo, t_hi, sigma, torch.ones_like(t_lo, dtype=torch.bool),
                               alpha_thre=0.0, early_stop_eps=0.0, impl=cfg.impl)
            aux_edges.append(s_edges)
            aux_weights.append(w)
            s_edges = pdf_resample(s_edges, w, n_next, jitters[i + 1])

        # the main field on the final bins: the padded path, every lane valid
        S = cfg.num_nerf_samples
        t_starts, t_ends, positions = positions_of(s_edges)
        mask = torch.ones_like(t_starts, dtype=torch.bool)
        flat_pos = positions.reshape(-1, 3)
        density, geo_feat = field_density(params, fc, flat_pos)
        density = density.reshape(R, S)
        flat_dirs = d_unit[:, None, :].expand(R, S, 3).reshape(-1, 3)
        flat_cam = cam_idx[:, None].expand(R, S).reshape(-1)
        heads = field_outputs(params, fc, flat_pos, flat_dirs, flat_cam, geo_feat,
                              train=train, step=step)
        heads = {k: v.reshape(R, S, -1) for k, v in heads.items()}
        if cfg.use_gradient_scaling:
            scaling = torch.clamp(((t_starts + t_ends) / 2.0) ** 2, 0.0, 1.0)
            density = _grad_scale(density, scaling)
            heads = {k: _grad_scale(v, scaling[..., None]) for k, v in heads.items()}
        weights = render_weights(t_starts, t_ends, density, mask, alpha_thre=0.0,
                                 early_stop_eps=0.0, impl=cfg.impl)

        outputs: Dict[str, torch.Tensor] = {
            "accumulation": render_accumulation(weights),
            "depth": render_depth_expected(weights, t_starts, t_ends, mask),
            "num_samples_per_ray": torch.full((R,), S, dtype=torch.int32, device=o.device),
        }
        self._ray_outputs(params, outputs, lambda key: accumulate(weights, heads[key]),
                          lambda key: accumulate(weights.detach(), heads[key]))
        if train:  # the proposal supervision's s-space histograms, for the loss
            for i, (e, w) in enumerate(zip(aux_edges, aux_weights)):
                outputs[f"prop_edges_{i}"] = e
                outputs[f"prop_weights_{i}"] = w
            outputs["final_edges"] = s_edges
            outputs["final_weights"] = weights
        return outputs

    def loss(
        self,
        outputs: Dict[str, torch.Tensor],
        batch: Dict[str, torch.Tensor],
        background: Optional[torch.Tensor] = None,
        step: int = 0,
    ) -> Dict[str, torch.Tensor]:
        """Loss terms (umhs_tpu/models/model.py:783-840); their sum is the
        training loss. `background` (R, 3) is the random background colour
        (the JAX package draws it as uniform(k_bg, (R, 3))), needed when
        background_color is "random". With the proposal histograms in the
        outputs (a proposal forward with train=True) the interlevel and
        distortion losses are added; with pred_dino and "dino_feat" in the
        batch, the DINO features' NaN-ignoring MSE and the cluster loss,
        which counts only once `step` is past 3000."""
        cfg = self.config
        pred_rgb, gt_rgb = self._blend_background_for_loss(
            outputs["rgb"], outputs["accumulation"], batch["image"], background)
        if cfg.method == "rgb":
            loss = {"rgb_loss": torch.mean((pred_rgb - gt_rgb) ** 2)}
        elif cfg.method == "spectral":
            loss = {"spectral_loss": torch.mean((outputs["spectral"] - batch["hs_image"]) ** 2)}
        elif cfg.method == "rgb+spectral":
            spectral_mse = torch.mean((outputs["spectral"] - batch["hs_image"]) ** 2)
            loss = {"spectral_loss": cfg.spectral_loss_weight * spectral_mse,
                    "rgb_loss": cfg.rgb_loss_weight * torch.mean((pred_rgb - gt_rgb) ** 2)}
        else:
            raise ValueError(f"unknown method {cfg.method}")

        if "final_edges" in outputs:
            loss["interlevel_loss"] = cfg.interlevel_loss_mult * sum(
                interlevel_loss(outputs[f"prop_edges_{i}"], outputs[f"prop_weights_{i}"],
                                outputs["final_edges"], outputs["final_weights"])
                for i in range(len(cfg.num_proposal_samples)))
            loss["distortion_loss"] = cfg.distortion_loss_mult * distortion_loss(
                outputs["final_edges"], outputs["final_weights"])
        if cfg.pred_dino and "dino_feat" in batch:
            loss["dino_mse"] = torch.nanmean((outputs["dino"] - batch["dino_feat"]) ** 2)
            cluster_w = 1.0 if step > 3000 else 0.0
            loss["cluster_loss"] = cluster_w * -torch.mean(
                torch.sum(outputs["cluster_probs"] * outputs["inner_products"], dim=1))
        return loss

    def _blend_background_for_loss(self, pred_rgb, accumulation, gt_image, background):
        """pred += bg * (1 - acc); RGBA ground truth composited over the same
        bg (black for black/last_sample, with no blending of pred)."""
        gt_rgb = gt_image[..., :3]
        opacity = gt_image[..., 3:4] if gt_image.shape[-1] == 4 else None
        mode = self.config.background_color
        if mode in ("random", "white"):
            if mode == "random":
                if background is None:
                    raise ValueError("background_color 'random' needs the background colours")
                bg = background.to(pred_rgb.dtype)
            else:
                bg = torch.ones_like(pred_rgb)
            pred_rgb = pred_rgb + bg * (1.0 - accumulation)
        else:
            bg = torch.zeros_like(pred_rgb)
        if opacity is not None:
            gt_rgb = gt_rgb * opacity + bg * (1.0 - opacity)
        return pred_rgb, gt_rgb

    def metrics(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """PSNR and RMSE against the ground truth over black, sample counts,
        the p99 of occupied candidates per ray (linear interpolation, as
        jnp.percentile) and the spectral PSNR/RMSE (model.py:872-898)."""
        gt_rgb = self.blend_background(batch["image"])
        mse = torch.mean((outputs["rgb"] - gt_rgb) ** 2)
        m = {
            "psnr": -10.0 * torch.log10(torch.clamp_min(mse, 1e-12)),
            "rmse": torch.sqrt(mse),
            "num_samples_per_batch": torch.sum(outputs["num_samples_per_ray"]),
        }
        if "num_occupied_per_ray" in outputs:
            m["num_occupied_p99"] = torch.quantile(
                outputs["num_occupied_per_ray"].float(), 0.99)
        i = 1
        while f"num_eval_s{i}_per_ray" in outputs:
            m[f"num_eval_s{i}_per_batch"] = torch.sum(outputs[f"num_eval_s{i}_per_ray"])
            i += 1
        if "spectral" in self.config.method and "hs_image" in batch:
            mse_s = torch.mean((outputs["spectral"] - batch["hs_image"]) ** 2)
            m["psnr_spectral"] = -10.0 * torch.log10(torch.clamp_min(mse_s, 1e-12))
            m["rmse_spectral"] = torch.sqrt(mse_s)
        return m

    def blend_background(self, image: torch.Tensor) -> torch.Tensor:
        """RGBA ground truth over black (white for a white background)."""
        if image.shape[-1] < 4:
            return image
        rgb, opacity = image[..., :3], image[..., 3:4]
        if self.config.background_color == "white":
            return rgb * opacity + (1.0 - opacity)
        return rgb * opacity
