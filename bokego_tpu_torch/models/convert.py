"""Carry weights over from the JAX package's Flax variables.

:func:`from_flax` maps ``{'params', 'batch_stats'}`` variables (nested dicts
of numpy arrays) onto the port's state-dict layout, which is the reference
torch layout: conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out,
in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
and the untied head bias (9, 9, 1) -> (1, 9, 9).  It is the port's own copy
of the mapping in ``bokego_tpu/models/convert.py`` (``_trunk_back``,
``_bn_back``, ``_dense_back``).  :func:`policy_v2_from_flax` does the same
for the legacy ``PolicyNetV2`` (no BatchNorm; the inverse of the JAX
package's ``policy_v2_from_torch``).  :func:`adam_from_optax` carries an
optax Adam/AdamW state over onto ``torch.optim.Adam``/``AdamW``'s, so that a
resumed training run can be held against the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_CONV_IDX = [0, 3, 6, 9, 12, 15, 18]  # Sequential indices of the trunk convs
_HEAD_IDX = 21
_V2_CONV_IDX = [0, 2, 4, 6, 8, 10]  # PolicyNetV2: conv, ReLU pairs
_V2_HEAD_IDX = 12


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _bn(sd: dict, key: str, p: dict, s: dict | None) -> None:
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])
    if s is None:  # parameters only
        return
    sd[f"{key}.running_mean"] = _np(s["mean"])
    sd[f"{key}.running_var"] = _np(s["var"])
    sd[f"{key}.num_batches_tracked"] = np.int64(0)


def _dense(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    sd[f"{key}.bias"] = _np(p["bias"])


def _conv(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = _np(p["bias"])


def _head(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _np(p["conv"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = _np(p["untied_bias"]).transpose(2, 0, 1)


def _trunk(sd: dict, params: dict, stats: dict | None) -> None:
    for i, ci in enumerate(_CONV_IDX):
        _conv(sd, f"conv.{ci}", params[f"conv{i}"])
        _bn(sd, f"conv.{ci + 1}", params[f"bn{i}"], None if stats is None else stats[f"bn{i}"])
    _head(sd, f"conv.{_HEAD_IDX}", params["head"])


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _net_sd(p: dict, s: dict | None) -> dict[str, Any]:
    """Params (and BatchNorm statistics unless ``s`` is None) -> state-dict
    entries."""

    def stats(key):
        return None if s is None else s[key]

    sd: dict[str, Any] = {}
    _trunk(sd, p["trunk"], stats("trunk"))
    if "lin1" in p:
        _bn(sd, "bn", p["bn_head"], stats("bn_head"))
        _bn(sd, "lin_bn", p["bn_lin"], stats("bn_lin"))
        _dense(sd, "lin1", p["lin1"])
        _dense(sd, "lin2", p["lin2"])
    return sd


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax PolicyNet or ValueNet variables -> the port's state dict.

    A ValueNet is recognised by its ``lin1`` dense layer."""
    return _tensors(_net_sd(variables["params"], variables["batch_stats"]))


def _find_adam(state):
    """The ``ScaleByAdamState`` inside an optax state (a nest of tuples)."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    for s in state if isinstance(state, (tuple, list)) else ():
        found = _find_adam(s)
        if found is not None:
            return found
    return None


def adam_from_optax(opt_state, net: torch.nn.Module) -> dict:
    """An optax ``adam``/``adamw`` state of ``net``'s Flax twin -> the
    ``{"state": ...}`` part of a ``torch.optim.Adam``/``AdamW`` state dict
    over ``net.parameters()`` (one parameter group, in module order).

    ``ScaleByAdamState(count, mu, nu)`` becomes ``step`` (float32, as torch
    keeps it), ``exp_avg`` and ``exp_avg_sq``, each moment laid out like the
    parameter it belongs to (the mapping of :func:`from_flax`).  Merge it
    into the optimizer's own ``state_dict()`` to keep its hyperparameters."""
    adam = _find_adam(opt_state)
    mu, nu = _tensors(_net_sd(adam.mu, None)), _tensors(_net_sd(adam.nu, None))
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {
        "state": {
            i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, (name, _) in enumerate(net.named_parameters())
        }
    }


def policy_v2_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax PolicyNetV2 variables (``{'params'}``, no BatchNorm) -> the
    state dict of the port's ``PolicyNetV2``."""
    p = variables["params"]
    sd: dict[str, Any] = {}
    for i, ci in enumerate(_V2_CONV_IDX):
        _conv(sd, f"conv.{ci}", p[f"conv{i}"])
    _head(sd, f"conv.{_V2_HEAD_IDX}", p["head"])
    return _tensors(sd)
