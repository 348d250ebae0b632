"""The rank functions of tests/test_torch_parallel.py.

umhs_torch.parallel.mesh.launch runs each in processes of its own, which import
it by name: it lives apart from the test file so that those processes import
neither JAX nor pytest's fixtures, only torch and umhs_torch.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from umhs_torch.engine.trainer import DynamicShapes, Trainer, TrainerConfig, named_leaves
from umhs_torch.models.model import ModelConfig


def digest(tensors):
    """sha1 of each tensor's bytes, by name."""
    return {k: hashlib.sha1(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                            .numpy().tobytes()).hexdigest() for k, v in tensors.items()}


def step_values_and_grads(trainer, draws):
    """trainer.reduced_step(draws) as floats, and every gradient the step
    reaches."""
    values = {k: float(v) for k, v in trainer.reduced_step(draws).items()}
    grads = {n: t.grad.detach().clone() for n, t in named_leaves(trainer.state["params"])
             if t.grad is not None}
    return values, grads


def grad_step_rank(mesh, payload):
    """The reduced step of each case in `payload` (JAX's parameters and
    occupancy state, the global draws, each case's march and budgets), the
    sharded eval forward of payload["eval_rays"], and the checks on the
    run that cli.train's launch_training trained (trained_run)."""
    torch.set_num_threads(1)
    p = payload
    dm = InMemoryDataManager(p["rgba"], p["cams"], hs_images=p["cubes"],
                             config=DataManagerConfig(train_num_rays_per_batch=p["rays"]),
                             wavelengths=p["wavelengths"], device="cpu")
    t = Trainer(TrainerConfig(seed=0, mixed_precision=False, save_final=False),
                ModelConfig(**p["model_kw"]), num_classes=p["num_classes"], datamanager=dm,
                mesh=mesh)
    out = {}
    for name, case in p["cases"].items():
        params = _tree_clone(p["params"])
        for _, leaf in named_leaves(params):
            leaf.requires_grad_(True)
        t.state = {"params": params, "occ": p["occ"], "step": p["step"]}
        march = t.model.march_config
        if case["samples"] is not None:
            march = dataclasses.replace(march, num_samples=case["samples"])
        t.dyn = DynamicShapes(p["rays"], march, tuple(case["budgets"]))
        out[name] = step_values_and_grads(t, p["draws"])
    t.state = {"params": _tree_clone(p["params"]), "occ": p["occ"], "step": p["step"]}
    out["eval"] = {k: v.clone() for k, v in t.eval_forward(p["eval_rays"]).items()}
    out["trained"] = trained_run(mesh, p["trained_config"], p["trained_checkpoints"])
    return out


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree.detach().clone()


def fail_rank(mesh):
    raise FileNotFoundError("no such file on this rank")


def trained_run(mesh, config, load_dir):
    """On a trained run's final checkpoint: a Trainer restored from it on
    this rank (its state's digest), a partial occupancy update's digest,
    the reduced step against one process on the same global draws (rank
    0), and the first step of a fresh run of `config` over the mesh."""
    restored = Trainer(dataclasses.replace(config.trainer, load_dir=load_dir),
                       config.pipeline.model, config.pipeline.datamanager,
                       num_classes=config.pipeline.num_classes, mesh=mesh).setup()
    out = {"restored": digest(restored.state_tensors())}
    restored.update_occupancy(full=False)
    out["occ_after_update"] = digest(restored.state["occ"])
    draws = restored.draw_step()
    out["mesh_step"] = step_values_and_grads(restored, draws)
    if mesh.rank == 0:
        solo = Trainer(config.trainer, restored.model.config,
                       num_classes=restored.model.num_classes, device=restored.device,
                       datamanager=restored.datamanager)
        solo.state, solo.dyn = restored.state, restored.dyn
        out["solo_step"] = step_values_and_grads(solo, draws)
    fresh = Trainer(dataclasses.replace(config.trainer, experiment_name="first-step",
                                        save_final=False),
                    config.pipeline.model, config.pipeline.datamanager,
                    num_classes=config.pipeline.num_classes, mesh=mesh).setup()
    fresh.train(1)
    out["first_step"] = fresh.history[0]["metrics"]
    return out
