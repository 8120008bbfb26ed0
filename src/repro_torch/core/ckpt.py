"""Atomic chunk-boundary checkpoints of the slot engine (twin of
``repro.core.ckpt``).

Layout: one snapshot is one ``ckpt-<tick>.npz`` in the spec's directory,
holding

  * ``__meta__``: a JSON blob (format version, tick, law name, total
    steps, slots, flows, engine flavour, record flag, the names of None
    leaves), used to reject an incompatible resume;
  * ``leaf:<path>``: every carry leaf, named by its NamedTuple path
    (``.state.w``, ``.law.gamma_smooth``; ``[i]`` in a plain tuple), dtype-
    and bit-exact; the host's tick counter as a 0-d int64;
  * ``rec:<path>``: the recorded trace so far (when recording), so that a
    resumed run returns the same whole-trace Record as an uninterrupted
    one.

Atomicity: the snapshot is written to a dot-prefixed temp file in the same
directory, flushed and ``fsync``ed, then ``os.replace``d into place; a
crash mid-write leaves the previous snapshot untouched and never a
truncated ``ckpt-*.npz``. Old snapshots beyond ``keep`` are removed only
after the new one is in place.

Every tensor leaf is copied to the host before it is written: the
megakernel updates its carry in place, so a view would take the next
segment's values. Restore never trusts the file's structure: leaves are
loaded into a template carry built by the same init that built the
original, ``fluid.audit_carry_dtypes`` runs on the raw numpy leaves
before any of them becomes a tensor (so a float64 leaf is rejected, never
downcast), and restored tensors land on the template's device.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from .types import CheckpointSpec

FORMAT_VERSION = 1
_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def _flatten_named(tree, path="") -> List[Tuple[str, object]]:
    """(path, leaf) pairs of nested tuples, None leaves included; a leaf is
    a tensor, a numpy array or a Python scalar."""
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            return [p for f, v in zip(tree._fields, tree)
                    for p in _flatten_named(v, f"{path}.{f}")]
        return [p for i, v in enumerate(tree)
                for p in _flatten_named(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves taken in order from
    ``leaves`` (consumed)."""
    if isinstance(tree, tuple):
        vals = [_unflatten(v, leaves) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            tuple(vals)
    return leaves.pop(0)


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host, as numpy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _pack(prefix: str, tree, arrays: dict, none_keys: List[str]) -> None:
    for name, leaf in _flatten_named(tree):
        key = f"{prefix}:{name}"
        if leaf is None:
            none_keys.append(key)
        else:
            arrays[key] = _host(leaf)


def save_checkpoint(spec: CheckpointSpec, tick: int, carry,
                    recs=None, meta: Optional[dict] = None) -> str:
    """Snapshot ``carry`` (and optional record segments) at ``tick``;
    returns the final path. The write is atomic (temp file, ``fsync``,
    ``os.replace``) and snapshots beyond ``spec.keep`` are removed only
    after the new one is in place."""
    os.makedirs(spec.path, exist_ok=True)
    none_keys: List[str] = []
    arrays: dict = {}
    _pack("leaf", carry, arrays, none_keys)
    if recs is not None:
        _pack("rec", recs, arrays, none_keys)
    full_meta = dict(meta or {})
    full_meta.update(version=FORMAT_VERSION, tick=int(tick),
                     none_keys=none_keys, has_recs=recs is not None)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(full_meta).encode(), dtype=np.uint8)
    final = os.path.join(spec.path, f"ckpt-{int(tick)}.npz")
    tmp = os.path.join(spec.path, f".tmp-ckpt-{int(tick)}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    if spec.keep and spec.keep > 0:
        for old in checkpoint_ticks(spec.path)[:-int(spec.keep)]:
            try:
                os.remove(os.path.join(spec.path, f"ckpt-{old}.npz"))
            except OSError:
                pass
    return final


def checkpoint_ticks(path: str) -> List[int]:
    """Snapshot ticks present in ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    ticks = []
    for name in os.listdir(path):
        m = _CKPT_RE.match(name)
        if m:
            ticks.append(int(m.group(1)))
    return sorted(ticks)


def latest_checkpoint(path: str) -> Optional[int]:
    """Newest snapshot tick in ``path``, or None when there is none."""
    ticks = checkpoint_ticks(path)
    return ticks[-1] if ticks else None


def read_meta(path: str, tick: int) -> dict:
    with np.load(os.path.join(path, f"ckpt-{tick}.npz")) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _restore(raw: np.ndarray, tmpl, to_device: bool):
    """A loaded leaf in the template's kind: a tensor on the template's
    device, a Python scalar of its type, or numpy."""
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(raw, device=tmpl.device) if to_device \
            else raw
    if isinstance(tmpl, (bool, int, float)) and not isinstance(
            tmpl, np.generic):
        return type(tmpl)(raw.item())
    return raw


def _unpack(prefix: str, template, z, none_keys, audit: bool,
            to_device: bool):
    flat = _flatten_named(template)
    want = {f"{prefix}:{p}" for p, _ in flat}
    have = ({k for k in z.files if k.startswith(f"{prefix}:")} |
            {k for k in none_keys if k.startswith(f"{prefix}:")})
    if want != have:
        raise ValueError(
            f"checkpoint layout mismatch for '{prefix}' tree: "
            f"missing={sorted(want - have)} unexpected={sorted(have - want)}"
            f" — the snapshot was written by a different scenario/engine")
    raw = []
    for path, tmpl in flat:
        key = f"{prefix}:{path}"
        if key in none_keys:
            if tmpl is not None:
                raise ValueError(
                    f"checkpoint leaf {key} is None but the template "
                    f"expects an array — engine flavour mismatch")
            raw.append(None)
            continue
        if tmpl is None:
            raise ValueError(
                f"checkpoint leaf {key} is an array but the template "
                f"expects None — engine flavour mismatch")
        raw.append(z[key])
    if audit:
        # on the raw numpy leaves that become tensors: a conversion would
        # hide the float64 leaf the audit exists to catch
        from .fluid import audit_carry_dtypes
        audit_carry_dtypes(_unflatten(template, [
            r if isinstance(t, torch.Tensor) else None
            for r, (_, t) in zip(raw, flat)]))
    leaves = [None if r is None else _restore(r, t, to_device)
              for r, (_, t) in zip(raw, flat)]
    return _unflatten(template, leaves)


def load_checkpoint(path: str, tick: int, carry_template,
                    rec_template=None, audit: bool = True,
                    to_device: bool = True):
    """Load snapshot ``tick`` into the shape of ``carry_template``.

    Returns ``(meta, carry, recs)``; ``recs`` is None unless the snapshot
    recorded and ``rec_template`` is given (its leaves come back as numpy).
    ``audit`` runs ``audit_carry_dtypes`` on the raw numpy leaves (float64
    rejection); ``to_device=False`` returns numpy arrays bit-identical to
    what was saved in place of the tensors.
    """
    with np.load(os.path.join(path, f"ckpt-{tick}.npz")) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version "
                             f"{meta.get('version')!r}")
        none_keys = set(meta.get("none_keys", ()))
        carry = _unpack("leaf", carry_template, z, none_keys, audit,
                        to_device)
        recs = None
        if rec_template is not None:
            if not meta.get("has_recs"):
                raise ValueError(
                    "checkpoint holds no recorded trace but record=True "
                    "was requested — re-run with record=False or "
                    "checkpoint with recording enabled")
            recs = _unpack("rec", rec_template, z, none_keys,
                           audit=False, to_device=False)
    return meta, carry, recs
