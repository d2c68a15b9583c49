"""Sampler snapshots for ``pmmh()`` checkpoint/resume (port of
``bayesssm_tpu/utils/checkpoint.py``).

A snapshot is one ``.npz`` file with the JAX package's field names:
``format_version``, ``key_data``, ``theta``, ``loglike``, ``samples``,
``step``, ``state_est`` and ``state_samples`` (latent-state collection
only) and a ``meta_<name>`` entry per item of ``meta``.

This module writes version 2, which differs from the JAX package's
version 1 in three ways:

* ``key_data`` holds the port's ``[C, 2]`` chain words (uint32), the words
  of its lowbias32 MH stream, not the JAX driver's threefry keys; the
  JAX loader refuses version 2, and ``pmmh(resume=True)`` refuses
  version 1, so neither driver resumes the other's stream;
* ``state_est`` is stored only when latent-state collection is on, never
  as a ``[C]`` zero placeholder;
* the temporary file is removed when the write fails.

The temporary file is ``<path>.tmp<rank>``, the rank of this process in
its ``torch.distributed`` group (0 without one), as the JAX package names
it by process index: under a mesh every rank writes the same full
snapshot (``pmmh()`` gathers the chains first), and distinct temporary
files keep concurrent writers on a shared file system off each other's
partial files; the renames are atomic and write identical content.

:func:`load_checkpoint` reads both versions.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from bayesssm_tpu_torch.utils.timing import host_sync

__all__ = ["save_checkpoint", "load_checkpoint", "FORMAT_VERSION"]

FORMAT_VERSION = 2
_READABLE = (1, 2)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        host_sync(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, *, keys, theta, loglike, samples, step: int,
                    state_est=None, state_samples=None,
                    meta: dict | None = None) -> None:
    """Write a sampler snapshot atomically: to ``<path>.tmp<rank>``, then
    renamed over ``path``; a failed write removes the temporary file and
    re-raises.

    ``keys`` are ``[C, 2]`` uint32 words (tensor or array), ``samples``
    the ``[C, step, P]`` samples so far, ``step`` their count (the initial
    sample included); ``state_est`` and ``state_samples`` only with
    latent-state collection. Tensors are copied to the host.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".tmp{_process_index()}")
    payload = {
        "format_version": np.asarray(FORMAT_VERSION),
        "key_data": _host(keys).astype(np.uint32),
        "theta": _host(theta),
        "loglike": _host(loglike),
        "samples": _host(samples),
        "step": np.asarray(step),
    }
    if state_est is not None:
        payload["state_est"] = _host(state_est)
    if state_samples is not None:
        payload["state_samples"] = _host(state_samples)
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = _host(v)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        tmp.replace(path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def load_checkpoint(path) -> dict:
    """Read a version 1 or 2 snapshot: a dict with ``format_version``,
    ``keys`` (the ``[C, 2]`` uint32 ``key_data``), ``step`` (an int),
    ``meta`` (the ``meta_*`` entries without their prefix) and every other
    field under its own name."""
    data = dict(np.load(pathlib.Path(path), allow_pickle=False))
    version = int(data.pop("format_version"))
    if version not in _READABLE:
        raise ValueError(f"unsupported checkpoint version {version}")
    out = {
        "format_version": version,
        "keys": data.pop("key_data"),
        "step": int(data.pop("step")),
    }
    meta = {}
    for k in list(data):
        if k.startswith("meta_"):
            meta[k[len("meta_"):]] = data.pop(k)
    out["meta"] = meta
    out.update(data)
    return out
