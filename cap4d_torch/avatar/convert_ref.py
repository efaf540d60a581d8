"""Reference avatar checkpoints, read and written (counterpart of
``cap4d_tpu/avatar/convert_ref.py``), and the carry-over of a JAX trainer
state.

The reference saves ``torch.save((capture, iteration), chkpnt{it}.pth)``
with (gaussianavatars/scene/cap4d_gaussian_model.py:443-450)

    {"shape" (FLAME) | "betas" (SMPL), "base_rot", "deform_net": <UnetGenerator state_dict>,
     "gaussians": (active_sh_degree, _xyz, _features_dc, _features_rest,
                   _scaling, _rotation, _opacity, binding, binding_counter,
                   max_radii2D, xyz_gradient_accum, denom,
                   optimizer_state_dict, spatial_lr_scale)}

The port's deform net has the reference's key names, so its state dict goes
in and out as it is. The Adam state is keyed by global parameter index in
the reference's group order (xyz, f_dc, f_rest, opacity, scaling, rotation,
then the deform net in registration order). State that only the JAX
package and the port keep (the whole FLAME bank, the neck rows and their
moments) rides under the extra key ``cap4d_tpu_extras``, which the
reference's ``restore`` ignores and the JAX package reads, so a checkpoint
written by either package loads into the other.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from cap4d_torch.avatar import gaussians as G

EXTRAS_KEY = "cap4d_tpu_extras"
_GAUSS_GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
_GROUP_TO_FIELD = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
                   "opacity": "opacity", "scaling": "scaling", "rotation": "rotation"}


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _level_paths(num_downs: int):
    """State-dict prefix of each U-Net level's (down, up) convolution,
    outermost first (see ``deform_net.py``)."""
    yield "model.model.0", "model.model.3"
    prefix = "model.model.1"
    for _ in range(1, num_downs - 1):
        yield f"{prefix}.model.1", f"{prefix}.model.5"
        prefix = f"{prefix}.model.3"
    yield f"{prefix}.model.1", f"{prefix}.model.3"


def infer_num_downs(sd: Dict[str, Any]) -> int:
    """U-Net depth from a reference UnetGenerator state dict's keys."""
    weight_keys = {k for k in sd if k.endswith(".weight")}
    for depth in range(2, 12):
        if {f"{p}.weight" for pair in _level_paths(depth) for p in pair} == weight_keys:
            return depth
    raise ValueError("state_dict does not look like a reference UnetGenerator "
                     f"(weight keys: {sorted(weight_keys)[:4]}...)")


def deform_state_dict_from_flax(params: Dict[str, Any], num_downs: int) -> Dict[str, torch.Tensor]:
    """The JAX package's flax UnetGenerator tree (down_i / up_i: kernel,
    bias) → reference-key state dict. Conv kernels (kh, kw, I, O) → (O, I,
    kh, kw); transposed-conv kernels are spatially mirrored and go to
    (I, O, kh, kw) (flax's is a fractionally strided conv, torch's the
    gradient of a conv)."""
    sd = OrderedDict()
    for i, (down, up) in enumerate(_level_paths(num_downs)):
        for path, grp, transposed in ((down, f"down_{i}", False), (up, f"up_{i}", True)):
            w = np.asarray(params[grp]["kernel"], np.float32)
            w = w[::-1, ::-1].transpose(2, 3, 0, 1) if transposed else w.transpose(3, 2, 0, 1)
            sd[f"{path}.weight"] = torch.tensor(np.ascontiguousarray(w))
            sd[f"{path}.bias"] = torch.tensor(np.asarray(params[grp]["bias"], np.float32))
    return sd


def load_jax_capture(trainer, capture: Dict[str, Any]) -> None:
    """Install ``cap4d_tpu``'s ``AvatarTrainer.capture()`` (numpy leaves)
    into a port trainer: the active rows of the gaussian store with their aux
    and Adam moments, the deform net and its moments, the neck rows and
    their moments, and the FLAME bank. Every tensor is a copy: the trainer
    updates its state in place."""
    dev = trainer.device
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    g = capture["gaussians"]
    aux = g["aux"]
    idx = np.nonzero(np.asarray(aux.active))[0]
    trainer.gauss = {f: t(np.asarray(getattr(g["params"], f))[idx]) for f in G.FIELDS}
    trainer.aux = {
        "binding": t(np.asarray(aux.binding)[idx].astype(np.int64)),
        "binding_counter": t(np.asarray(aux.binding_counter).astype(np.int32)),
        "max_radii2d": t(np.asarray(aux.max_radii2d)[idx]),
        "xyz_gradient_accum": t(np.asarray(aux.xyz_gradient_accum)[idx]),
        "denom": t(np.asarray(aux.denom)[idx]),
    }
    mo = g["moments"]
    for key in ("gauss_m", "gauss_v"):
        trainer.moments[key] = {f: t(np.asarray(getattr(mo[key], f))[idx]) for f in G.FIELDS}
    num_downs = trainer.config.n_unet_layers
    trainer.deform_net.load_state_dict(deform_state_dict_from_flax(capture["deform_net"], num_downs))
    for key in ("deform_m", "deform_v"):
        sd = deform_state_dict_from_flax(mo[key], num_downs)
        trainer.moments[key] = {k: v.to(dev) for k, v in sd.items()}
    trainer.moments["neck_m"] = t(mo["neck_m"])
    trainer.moments["neck_v"] = t(mo["neck_v"])
    trainer.neck_weight = t(capture["neck_weight"]).float()
    trainer.flame_bank = {k: t(v).float() for k, v in capture["bank"].items()}
    trainer.active_sh_degree = int(g["active_sh_degree"])


def build_reference_capture(trainer, iteration: int) -> Dict[str, Any]:
    """Trainer state → the reference's capture dict (CPU torch leaves)."""
    from cap4d_torch.avatar.trainer import expon_lr

    cpu = lambda x: x.detach().cpu().contiguous()
    gp, aux, mo = trainer.gauss, trainer.aux, trainer.moments
    state, pidx = {}, 0
    step_t = torch.tensor(float(iteration))

    def add_state(m, v):
        nonlocal pidx
        state[pidx] = {"step": step_t, "exp_avg": cpu(m), "exp_avg_sq": cpu(v)}
        pidx += 1

    for gname in _GAUSS_GROUPS:
        f = _GROUP_TO_FIELD[gname]
        add_state(mo["gauss_m"][f], mo["gauss_v"][f])
    deform_ids = []
    for name, _ in trainer.deform_net.named_parameters():
        deform_ids.append(pidx)
        add_state(mo["deform_m"][name], mo["deform_v"][name])

    # the real per-group learning rates: torch's load_state_dict overwrites
    # the fresh groups' lrs with these, and the reference re-sets only xyz and
    # deform_net every iteration (cap4d_gaussian_model.py:426-441)
    opt = trainer.opt
    sls = float(trainer.spatial_lr_scale) or 1.0
    lrs = {"xyz": expon_lr(iteration, opt["position_lr_init"] * sls,
                           opt["position_lr_final"] * sls,
                           lr_delay_mult=opt["position_lr_delay_mult"],
                           max_steps=opt["position_lr_max_steps"]),
           "f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
           "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
           "rotation": opt["rotation_lr"],
           "deform_net": expon_lr(iteration, opt["deform_net_lr_init"],
                                  opt["deform_net_lr_final"],
                                  lr_delay_mult=opt["deform_net_lr_delay_mult"],
                                  max_steps=opt["deform_net_lr_max_steps"])}
    common = {"betas": (0.9, 0.999), "eps": 1e-15, "amsgrad": False, "maximize": False,
              "foreach": None, "capturable": False, "differentiable": False, "fused": None}
    opt_state = {"state": state, "param_groups": [
        {"lr": float(lrs[g]), "weight_decay": 0, **common, "name": g, "params": [i]}
        for i, g in enumerate(_GAUSS_GROUPS)] + [
        {"lr": float(lrs["deform_net"]), "weight_decay": float(opt.get("deform_net_w_decay", 0.0)),
         **common, "name": "deform_net", "params": deform_ids}]}

    gauss_tuple = (
        int(trainer.active_sh_degree),
        cpu(gp["xyz"]), cpu(gp["features_dc"]), cpu(gp["features_rest"]),
        cpu(gp["scaling"]), cpu(gp["rotation"]), cpu(gp["opacity"]),
        cpu(aux["binding"]).to(torch.int64), cpu(aux["binding_counter"]).to(torch.int32),
        cpu(aux["max_radii2d"]), cpu(aux["xyz_gradient_accum"])[:, None],
        cpu(aux["denom"])[:, None], opt_state, float(trainer.spatial_lr_scale),
    )
    bank = {k: _to_np(v) for k, v in trainer.flame_bank.items()}
    shape_key = trainer.shape_key   # an SMPL checkpoint carries "betas"
    return {
        shape_key: torch.as_tensor(bank[shape_key]),
        "base_rot": torch.as_tensor(bank["base_rot"]),
        "deform_net": OrderedDict((k, cpu(v)) for k, v in trainer.deform_net.state_dict().items()),
        "gaussians": gauss_tuple,
        EXTRAS_KEY: {"bank": bank, "neck_weight": _to_np(trainer.neck_weight),
                     "neck_m": _to_np(mo["neck_m"]), "neck_v": _to_np(mo["neck_v"])},
    }


def save_reference_checkpoint(trainer, path: Path, iteration: int) -> Path:
    """torch.save((capture, iteration)) in the reference's layout (train.py:248)."""
    torch.save((build_reference_capture(trainer, iteration), iteration), str(path))
    return Path(path)


def load_reference_avatar_checkpoint(path: Path) -> Tuple[Dict[str, Any], int]:
    """Read a chkpnt*.pth written by the reference, the JAX package or the
    port → (capture dict, iteration)."""
    chkpt, iteration = torch.load(str(path), map_location="cpu", weights_only=False)
    return chkpt, int(iteration)


def restore_reference_checkpoint(trainer, chkpt: Dict[str, Any], with_extras: bool = True) -> None:
    """Install a reference capture dict into a trainer: the exact-size
    gaussian store, its aux and Adam moments (zeros where the optimizer state
    is absent), the deform net and its moments, shape and base rotation,
    and, with ``with_extras``, the fit's whole FLAME bank and neck rows.

    Resuming a fit wants the extras; driving the avatar with another
    sequence does not (its bank holds the driving frames, and the neck rows
    of the fit's frames do not apply to them), as in the reference, whose
    checkpoint carries neither."""
    (active_sh_degree, xyz, f_dc, f_rest, scaling, rotation, opacity, binding,
     binding_counter, max_radii2d, grad_accum, denom, opt_state,
     spatial_lr_scale) = chkpt["gaussians"]
    dev = trainer.device
    t = lambda a, dt=torch.float32: torch.tensor(_to_np(a), dtype=dt, device=dev)
    trainer.gauss = {"xyz": t(xyz), "features_dc": t(f_dc), "features_rest": t(f_rest),
                     "scaling": t(scaling), "rotation": t(rotation), "opacity": t(opacity)}
    n = trainer.gauss["xyz"].shape[0]
    bind = t(binding, torch.int64)
    bc = t(binding_counter, torch.int32)
    n_faces = trainer.uv.remesh_faces.shape[0]
    if bc.shape[0] != n_faces:   # face count mismatch → recount
        bc = torch.bincount(bind, minlength=n_faces).to(torch.int32)
    trainer.aux = {"binding": bind, "binding_counter": bc,
                   "max_radii2d": t(max_radii2d).reshape(n),
                   "xyz_gradient_accum": t(grad_accum).reshape(n),
                   "denom": t(denom).reshape(n)}
    trainer.active_sh_degree = int(active_sh_degree)
    trainer.spatial_lr_scale = float(spatial_lr_scale) or 1.0

    num_downs = trainer.config.n_unet_layers
    ckpt_downs = infer_num_downs(chkpt["deform_net"])
    if ckpt_downs != num_downs:
        raise ValueError(f"checkpoint deform net has {ckpt_downs} U-Net levels but the model "
                         f"config says n_unet_layers={num_downs} — load the checkpoint with the "
                         "config_dump.yaml it was trained with")
    trainer.deform_net.load_state_dict({k: torch.as_tensor(_to_np(v))
                                        for k, v in chkpt["deform_net"].items()})

    names = {pg.get("name"): pg["params"] for pg in (opt_state or {}).get("param_groups", [])}
    st = (opt_state or {}).get("state", {})

    def pair(pid, like):
        s = st.get(pid)
        if s is None:
            return torch.zeros_like(like), torch.zeros_like(like)
        return t(s["exp_avg"]).reshape(like.shape), t(s["exp_avg_sq"]).reshape(like.shape)

    gm, gv = {}, {}
    for gname in _GAUSS_GROUPS:
        f = _GROUP_TO_FIELD[gname]
        ids = names.get(gname) or [None]
        gm[f], gv[f] = pair(ids[0], trainer.gauss[f])
    trainer.moments["gauss_m"], trainer.moments["gauss_v"] = gm, gv
    dnames = [k for k, _ in trainer.deform_net.named_parameters()]
    ids = names.get("deform_net", [])
    dparams = dict(trainer.deform_net.named_parameters())
    dm, dv = {}, {}
    for k, pid in zip(dnames, ids if len(ids) == len(dnames) else [None] * len(dnames)):
        dm[k], dv[k] = pair(pid, dparams[k])
    trainer.moments["deform_m"], trainer.moments["deform_v"] = dm, dv

    extras = chkpt.get(EXTRAS_KEY) if with_extras else None
    if extras is not None:
        for k, v in extras["bank"].items():
            trainer.flame_bank[k] = t(v)
        trainer.neck_weight = t(extras["neck_weight"])
        trainer.moments["neck_m"] = t(extras["neck_m"])
        trainer.moments["neck_v"] = t(extras["neck_v"])
    trainer.flame_bank[trainer.shape_key] = t(chkpt.get("shape", chkpt.get("betas")))
    trainer.flame_bank["base_rot"] = t(chkpt["base_rot"])
