"""Checkpoints and the versioned opponent pool (counterpart of
``bokego_tpu/train/checkpoints.py``).

The JAX package writes orbax directories; the port writes ``torch.save``
files in the reference's own layout, ``{"model_state_dict",
"optimizer_state_dict"[, "epoch"]}``, which ``nets.load_policy`` /
``nets.load_value`` read.  Every write is atomic: a temporary file in the
target's directory, then ``os.replace``, so a crash leaves the old file or
the new one, never a torn one.  The pool keeps the ``policy_<n>`` numbering
as ``policy_<n>.pt`` files, each marked with its ``pool_generation``.

Orbax directories cannot be read without jax: the loaders raise on them and
name the export route (``tools/export_policy_torch.py``) instead of skipping
them.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

_EXPORT = (
    "export it to a torch .pt file with tools/export_policy_torch.py "
    "(--kind policy or --kind value; needs jax)"
)


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".pt")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_variables(path: str, net: torch.nn.Module, optimizer=None, meta: dict | None = None) -> None:
    """Save a net (+ optional optimizer state and metadata such as
    ``epoch``) in the reference layout."""
    payload = {"model_state_dict": net.state_dict()}
    if optimizer is not None:
        payload["optimizer_state_dict"] = optimizer.state_dict()
    payload.update(meta or {})
    atomic_save(payload, path)


def load_checkpoint(path: str) -> dict:
    """The payload dict of a ``.pt`` checkpoint, on the CPU."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory, which the port cannot read; {_EXPORT}")
    return torch.load(path, map_location="cpu", weights_only=True)


# -- opponent pool (policy_<n>.pt files) -------------------------------------

_POOL_RE = re.compile(r"policy_(\d+)(\.pt)?$")


def pool_ids(weights_dir: str) -> list[int]:
    """Sorted generation numbers present in the pool.  A ``policy_<n>.pt``
    counts only when :func:`save_next_policy` wrote it (its
    ``pool_generation`` is ``n``), so an exported or shipped net that
    happens to bear such a name (``data/weights/policy_17.pt``) is never
    taken for a generation; the JAX package's pool likewise counts only its
    own ``policy_<n>`` directories."""
    if not os.path.isdir(weights_dir):
        return []
    out = []
    for name in os.listdir(weights_dir):
        m = _POOL_RE.match(name)
        if not m:
            continue
        path = os.path.join(weights_dir, name)
        if m.group(2) is None:
            if os.path.isdir(path):
                raise ValueError(f"{path} is an orbax pool member; {_EXPORT}")
            continue
        n = int(m.group(1))
        if os.path.isfile(path) and torch.load(path, map_location="cpu", mmap=True, weights_only=True).get(
            "pool_generation"
        ) == n:
            out.append(n)
    return sorted(out)


def pool_path(weights_dir: str, n: int) -> str:
    return os.path.join(weights_dir, f"policy_{n}.pt")


def latest_policy(weights_dir: str) -> tuple[int, dict] | None:
    ids = pool_ids(weights_dir)
    if not ids:
        return None
    n = ids[-1]
    return n, load_checkpoint(pool_path(weights_dir, n))


def next_generation(weights_dir: str, count: int = 1) -> int:
    """The number of the pool's next generation, once the files of the next
    ``count`` generations are found free.  A ``policy_<n>.pt`` there that is
    not a generation (a shipped or exported net such as
    ``data/weights/policy_17.pt``, or a pool written without
    ``pool_generation``) raises: the pool never writes over it."""
    ids = pool_ids(weights_dir)
    n = (ids[-1] + 1) if ids else 0
    for m in range(n, n + count):
        path = pool_path(weights_dir, m)
        if os.path.lexists(path):
            raise FileExistsError(
                f"{path} is not generation {m} of the pool in {weights_dir} (it holds no pool_generation {m}), "
                "and the pool does not write over it: move it away or grow the pool in another directory"
            )
    return n


def save_next_policy(weights_dir: str, net: torch.nn.Module, optimizer=None) -> int:
    """Append the next generation to the pool (:func:`next_generation`);
    returns its number."""
    n = next_generation(weights_dir)
    save_variables(pool_path(weights_dir, n), net, optimizer, {"pool_generation": n})
    return n


def sample_opponent(weights_dir: str, rng: np.random.Generator) -> tuple[int, dict]:
    """A random previous generation (``policy_0`` = the seed policy)."""
    ids = pool_ids(weights_dir)
    if not ids:
        raise FileNotFoundError(f"no policies in {weights_dir}")
    n = int(rng.choice(ids))
    return n, load_checkpoint(pool_path(weights_dir, n))
