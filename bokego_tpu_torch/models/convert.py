"""Carry weights over from the JAX package's Flax variables.

:func:`from_flax` maps ``{'params', 'batch_stats'}`` variables (nested dicts
of numpy arrays) onto the port's state-dict layout, which is the reference
torch layout: conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out,
in), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
and the untied head bias (9, 9, 1) -> (1, 9, 9).  It is the port's own copy
of the mapping in ``bokego_tpu/models/convert.py`` (``_trunk_back``,
``_bn_back``, ``_dense_back``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_CONV_IDX = [0, 3, 6, 9, 12, 15, 18]  # Sequential indices of the trunk convs
_HEAD_IDX = 21


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _bn(sd: dict, key: str, p: dict, s: dict) -> None:
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])
    sd[f"{key}.running_mean"] = _np(s["mean"])
    sd[f"{key}.running_var"] = _np(s["var"])
    sd[f"{key}.num_batches_tracked"] = np.int64(0)


def _dense(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    sd[f"{key}.bias"] = _np(p["bias"])


def _trunk(sd: dict, params: dict, stats: dict) -> None:
    for i, ci in enumerate(_CONV_IDX):
        conv = params[f"conv{i}"]
        sd[f"conv.{ci}.weight"] = _np(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"conv.{ci}.bias"] = _np(conv["bias"])
        _bn(sd, f"conv.{ci + 1}", params[f"bn{i}"], stats[f"bn{i}"])
    head = params["head"]
    sd[f"conv.{_HEAD_IDX}.weight"] = _np(head["conv"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"conv.{_HEAD_IDX}.bias"] = _np(head["untied_bias"]).transpose(2, 0, 1)


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax PolicyNet or ValueNet variables -> the port's state dict.

    A ValueNet is recognised by its ``lin1`` dense layer."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, Any] = {}
    _trunk(sd, p["trunk"], s["trunk"])
    if "lin1" in p:
        _bn(sd, "bn", p["bn_head"], s["bn_head"])
        _bn(sd, "lin_bn", p["bn_lin"], s["bn_lin"])
        _dense(sd, "lin1", p["lin1"])
        _dense(sd, "lin2", p["lin2"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
