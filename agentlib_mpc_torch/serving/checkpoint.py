"""Durable :class:`ServingPlane` snapshots: crash recovery as cache splices.

Port of ``agentlib_mpc_tpu/serving/checkpoint.py`` in the port's format:
the arrays go through :func:`agentlib_mpc_torch.utils.checkpoint.
save_pytree` (``torch.save``), not orbax, so the two packages cannot read
each other's plane checkpoints. Engines are never stored. A checkpoint
holds what the engines cannot rebuild (tenant identity, slot occupancy,
warm-start state, guard and health ladders, SLO ledgers, queue
carryover), and the restore reconstructs every bucket THROUGH the
:class:`~agentlib_mpc_torch.serving.cache.CompileCache` and fingerprint
path: against a warm cache (a supervisor restart sharing the process's
cache) recovery is a cached-join splice per tenant, not an engine build.

On-disk layout (one checkpoint directory)::

    <path>/
      arrays/          # save_pytree: per-bucket FusedState + theta + mask
      manifest.json    # everything else; written LAST = completeness marker

Saves use the JAX package's temp-dir + rename protocol (a kill mid-save
leaves the previous checkpoint at a ``.old-*`` sibling; a save killed
while writing leaves a manifest-less temp dir that
:func:`has_plane_checkpoint` rejects), and the restore refuses what the
JAX package refuses: a non-empty plane, a missing spec, a tenant whose
spec no longer fingerprints into its recorded bucket, a different slot
topology, a half-written checkpoint, and damaged arrays (their stored
structure, shapes and dtypes are checked against the rebuilt buckets).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import NamedTuple

import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.utils.checkpoint import (
    _stale_siblings,
    load_pytree,
    save_pytree,
)

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
ARRAYS = "arrays"
VERSION = 1


class RestoreReport(NamedTuple):
    """What a crash recovery cost: the time-to-recover evidence."""

    tenants: tuple            # restored tenant ids, plane order
    buckets: int
    #: engines that had to be BUILT during the restore; 0 against a warm
    #: cache, the acceptance bar
    cold_builds: int
    #: compile-cache engine reuses during the restore (one per tenant)
    cache_hits: int
    #: queued requests re-enqueued from the checkpoint's carryover
    requeued: int
    #: per-tenant restore wall seconds (engine acquisition for the
    #: bucket seed, splice bookkeeping for the rest)
    per_tenant_s: dict
    #: whole-restore wall seconds: the measured time to recover
    total_s: float


def _checkpoint_dir(path: str) -> "str | None":
    """The directory to restore from: the primary when complete, else the
    newest complete crash-recovery sibling; None when nothing with a
    manifest exists."""
    if os.path.isfile(os.path.join(path, MANIFEST)):
        return path
    for candidate in reversed(_stale_siblings(path)):
        if os.path.isfile(os.path.join(candidate, MANIFEST)):
            return candidate
    return None


def has_plane_checkpoint(path: str) -> bool:
    """True when :func:`restore_plane` has something COMPLETE to try (the
    manifest is written after the arrays, so a save killed mid-write
    leaves a directory this rejects)."""
    return _checkpoint_dir(os.path.abspath(path)) is not None


def plane_checkpoint_topology(path: str) -> "dict | None":
    """The slot topology a complete checkpoint was saved under, or None
    when there is no complete checkpoint. Lets a restarting supervisor
    pick a matching plane config without tripping :func:`restore_plane`'s
    drift rejection."""
    src = _checkpoint_dir(os.path.abspath(path))
    if src is None:
        return None
    with open(os.path.join(src, MANIFEST)) as fh:
        manifest = json.load(fh)
    return manifest.get("topology")


def _topology(plane) -> dict:
    return {"slot_multiple": int(plane.slot_multiple),
            "mesh_devices": None, "mesh_axis": None, "mesh_shape": None,
            "backend_devices": 1}


def save_plane(plane, path: str) -> str:
    """Snapshot a :class:`~agentlib_mpc_torch.serving.plane.ServingPlane`
    to ``path`` (a directory), crash-safely: per bucket the occupancy,
    warm-start state, theta batch and mask; per tenant the guard and
    health positions; the SLO ledger; the pending queue (identity,
    deadline and age: parameter payloads re-solve on the lane's last
    splice). In-flight pipelined rounds are not drained: the state
    already moved past them at launch, and their undelivered results die
    with the process like any crash-window output. Returns the absolute
    path."""
    path = os.path.abspath(path)
    now = time.monotonic()
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    buckets, arrays = [], []
    for key, bucket in plane._buckets.items():
        if not bucket.tenants:
            # every member is health-evicted: its lanes are padding and
            # stale iterates, and a re-admission splices a fresh start
            continue
        buckets.append({
            "digest": key.digest,
            "capacity": int(bucket.capacity),
            "slots": list(bucket.slots),
            "rounds_served": int(bucket.rounds_served),
            "scenarios": int(getattr(bucket, "n_scenarios", 1)),
        })
        arrays.append({"state": bucket.state,
                       "theta": bucket.theta_batch,
                       "mask": torch.as_tensor(bucket.mask)})

    manifest = {
        "version": VERSION,
        "rounds": int(plane.rounds),
        "topology": _topology(plane),
        "device": str(plane.device),
        "dtype": str(plane.dtype),
        "buckets": buckets,
        "evicted": {tid: key.digest
                    for tid, key in plane._evicted.items()},
        "guards": {tid: guard.snapshot()
                   for tid, guard in plane._guards.items()},
        "health": (plane._health.snapshot()
                   if plane._health is not None else None),
        # a restore that forgot the burn would report a fresh budget
        # mid-incident
        "slo": plane.slo.snapshot(),
        "autopilot": None,
        "queue": plane.queue.snapshot(now),
    }
    if arrays:
        save_pytree(os.path.join(tmp, ARRAYS), arrays)
    # manifest LAST: its presence is the completeness marker
    with open(os.path.join(tmp, MANIFEST), "w") as fh:
        json.dump(manifest, fh)

    if os.path.isdir(path):
        old = f"{path}.old-{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
    else:
        os.rename(tmp, path)
    for stale in _stale_siblings(path):
        shutil.rmtree(stale, ignore_errors=True)
    telemetry.journal_event(
        "checkpoint.saved", path=path,
        tenants=len(plane._tenant_bucket), buckets=len(buckets),
        queued=len(manifest["queue"]))
    logger.info("serving plane checkpointed to %s (%d tenants, %d "
                "buckets, %d queued)", path, len(plane._tenant_bucket),
                len(buckets), len(manifest["queue"]))
    return path


def _reject(src: str, reason: str, **fields) -> None:
    telemetry.journal_event("checkpoint.rejected", path=src, reason=reason,
                            **fields)


def restore_plane(plane, path: str, specs) -> RestoreReport:
    """Restore a checkpointed plane into ``plane``, which must be empty.
    ``specs`` supplies the tenants' problem definitions (a dict
    ``tenant_id -> TenantSpec`` or an iterable of specs): specs hold live
    OCP objects, which no checkpoint serializes.

    Buckets are rebuilt through the fingerprint and compile-cache path:
    against a warm cache every engine acquisition is a hit. A tenant
    whose spec fingerprints into a DIFFERENT bucket than the checkpoint
    recorded fails with ``ValueError`` before any state is spliced."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    src = _checkpoint_dir(path)
    if src is None:
        if os.path.isdir(path) or _stale_siblings(path):
            _reject(path, "incomplete_manifest")
            raise RuntimeError(
                f"checkpoint at {path} exists but no complete manifest "
                f"was found (save killed mid-write?) — refusing to "
                f"restore a half-written plane")
        raise FileNotFoundError(f"no plane checkpoint at {path}")
    if plane._tenant_bucket or plane._buckets:
        raise ValueError("restore_plane needs an EMPTY plane; this one "
                         f"has {len(plane._tenant_bucket)} tenants")
    with open(os.path.join(src, MANIFEST)) as fh:
        manifest = json.load(fh)
    if int(manifest.get("version", -1)) != VERSION:
        raise ValueError(
            f"plane checkpoint version {manifest.get('version')} is not "
            f"supported (expected {VERSION})")
    topo = manifest.get("topology") or {}
    want = _topology(plane)
    if (topo.get("mesh_shape"), topo.get("mesh_devices"),
            int(topo.get("slot_multiple", 0))) != \
            (want["mesh_shape"], want["mesh_devices"],
             want["slot_multiple"]):
        _reject(src, "topology_drift", saved_topology=topo,
                want_topology=want)
        raise ValueError(
            f"checkpoint topology mismatch: saved with {topo}, restoring "
            f"into {want} — slot layouts would misalign. Either (a) "
            f"restore into a plane built on the recorded topology "
            f"(slot_multiple={topo.get('slot_multiple')}), or (b) start "
            f"an empty plane and re-join every tenant from its spec "
            f"(capacities re-pad and warm starts reset)")

    hits0, misses0 = plane.cache.hits, plane.cache.misses

    def load_arrays(templates):
        try:
            return load_pytree(os.path.join(src, ARRAYS), templates)
        except (OSError, ValueError, RuntimeError, EOFError) as exc:
            _reject(src, "arrays_unreadable", error=repr(exc)[:300])
            raise RuntimeError(
                f"checkpoint at {src}: the arrays could not be restored "
                f"({type(exc).__name__}: {exc}) — refusing to splice "
                f"damaged state") from exc

    n_buckets, per_tenant_s, requeued = restore_into(
        plane, manifest, specs, load_arrays)
    report = RestoreReport(
        tenants=plane.tenants,
        buckets=n_buckets,
        cold_builds=plane.cache.misses - misses0,
        cache_hits=plane.cache.hits - hits0,
        requeued=requeued,
        per_tenant_s=per_tenant_s,
        total_s=time.perf_counter() - t0,
    )
    telemetry.journal_event(
        "checkpoint.restored", path=src,
        tenants=len(report.tenants), buckets=report.buckets,
        cold_builds=report.cold_builds, cache_hits=report.cache_hits,
        requeued=requeued, mttr_s=round(report.total_s, 4))
    logger.info(
        "serving plane restored from %s: %d tenants / %d buckets in "
        "%.1f ms (%d cold builds, %d cache hits, %d requeued)", src,
        len(report.tenants), report.buckets, 1e3 * report.total_s,
        report.cold_builds, report.cache_hits, requeued)
    return report


def restore_into(plane, manifest: dict, specs, load_arrays,
                 check_digests: bool = True):
    """Rebuild the buckets, registrations, ladders, ledgers and queue a
    manifest describes into the empty ``plane``: the part of
    :func:`restore_plane` after its refusals, shared with
    ``utils.convert.load_serving_state`` (which carries a JAX plane's
    state, whose bucket digests are the JAX package's and are not
    checked: ``check_digests=False`` checks instead that every tenant of
    a bucket fingerprints into one port bucket). ``load_arrays(templates)``
    returns per restored bucket ``{"state", "theta", "mask"}`` shaped like
    its template. Returns ``(buckets, per_tenant_s, requeued)``."""
    from agentlib_mpc_torch.serving.admission import SolveRequest
    from agentlib_mpc_torch.serving.fingerprint import bucket_key
    from agentlib_mpc_torch.serving.health import EVICTED

    if not isinstance(specs, dict):
        specs = {s.tenant_id: s for s in specs}
    # the join path's door applies on restore too: an S=1 scenario tree
    # normalizes into the flat spec, and thetas move to the plane
    specs = {tid: plane._door_spec(s) for tid, s in specs.items()}

    def spec_of(tid: str, what: str = "tenant"):
        spec = specs.get(tid)
        if spec is None:
            raise KeyError(f"checkpoint names {what} {tid!r} but specs "
                           f"has no entry for it")
        return spec

    def check(key, tid: str, recorded: str) -> None:
        if check_digests and key.digest != recorded:
            raise ValueError(
                f"tenant {tid!r} fingerprints into bucket {key.digest}, "
                f"but the checkpoint recorded {recorded} — the spec's "
                f"structure changed since the save; restore into "
                f"matching config")

    per_tenant_s: dict = {}
    templates, restored_buckets = [], []
    for entry in manifest["buckets"]:
        tenants = [t for t in entry["slots"] if t is not None]
        if not tenants:
            continue
        seed_spec = spec_of(tenants[0])
        key = bucket_key(seed_spec)
        check(key, tenants[0], entry["digest"])
        t_seed = time.perf_counter()
        bucket, _hit = plane._acquire_bucket(
            key, seed_spec, n_needed=1, capacity=entry["capacity"])
        per_tenant_s[tenants[0]] = time.perf_counter() - t_seed
        for tid in tenants:
            t_t = time.perf_counter()
            spec = spec_of(tid)
            if tid != tenants[0]:
                other = bucket_key(spec)
                check(other, tid, entry["digest"])
                if other != key:
                    raise ValueError(
                        f"tenant {tid!r} no longer fingerprints into "
                        f"its recorded bucket {entry['digest']}")
                plane.cache.note_hit(label=key.digest)
                per_tenant_s[tid] = time.perf_counter() - t_t
            plane._register_tenant(tid, key, spec)
        bucket.restore_occupancy(entry["slots"])
        bucket.rounds_served = int(entry["rounds_served"])
        templates.append({"state": bucket.state,
                          "theta": bucket.theta_batch,
                          "mask": torch.as_tensor(bucket.mask)})
        restored_buckets.append((key, bucket, entry))

    if restored_buckets:
        restored = load_arrays(templates)
        for (key, bucket, entry), data in zip(restored_buckets, restored):
            if not torch.equal(torch.as_tensor(data["mask"]).cpu(),
                               torch.as_tensor(bucket.mask)):
                raise ValueError(
                    f"bucket {entry['digest']}: restored mask does not "
                    f"match the manifest occupancy — checkpoint is "
                    f"internally inconsistent")
            bucket.state = data["state"]
            bucket.theta_batch = data["theta"]

    # evicted tenants: registered (spec, guard, ladder position) but in
    # no slot; their re-admission clock resumes where it was
    for tid, digest in (manifest.get("evicted") or {}).items():
        key = bucket_key(spec_of(tid, "evicted tenant"))
        if check_digests and key.digest != digest:
            raise ValueError(
                f"evicted tenant {tid!r} no longer fingerprints into "
                f"its recorded bucket {digest}")
        if tid not in plane._tenant_bucket:
            plane._register_tenant(tid, key, specs[tid])
        plane._evicted[tid] = key

    for tid, snap in (manifest.get("guards") or {}).items():
        guard = plane._guards.get(tid)
        if guard is not None:
            guard.restore(snap)
    if plane._health is not None and manifest.get("health"):
        plane._health.restore(manifest["health"])
        # a tenant the ledger says is evicted must be in the evicted set
        for tid in plane.tenants:
            if plane._health.state(tid) == EVICTED \
                    and tid not in plane._evicted:
                plane._evicted[tid] = plane._tenant_bucket[tid]

    now = time.monotonic()
    requeued = 0
    for entry in manifest.get("queue") or []:
        if entry["tenant_id"] not in plane._tenant_bucket:
            continue
        if plane.queue.submit(SolveRequest(
                tenant_id=entry["tenant_id"], theta=None,
                submitted_at=now - float(entry.get("elapsed_s") or 0.0),
                deadline_s=entry.get("deadline_s"))):
            requeued += 1
    plane.rounds = int(manifest.get("rounds") or 0)
    plane.slo.restore(manifest.get("slo"))
    plane.served_rounds = plane.slo.rounds
    telemetry.journal_set_round(plane.served_rounds)
    plane._export_active()
    return len(restored_buckets), per_tenant_s, requeued
