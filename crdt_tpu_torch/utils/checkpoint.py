"""Checkpoint and resume (own copy of ``crdt_tpu.utils.checkpoint``): a
replica's state on disk, in the JAX package's file format, so a snapshot
written by either package restores into the other.

A snapshot directory holds ``log.npz`` (the op log's seven columns,
full capacity), ``meta.json`` (rid, seq counter, clock epoch, the
interner tables, the raw command map, the frontier and summary, and the
store's audit digest), one JSON section per sibling (``set.json``,
``seq.json``, ``map.json``, ``composite.json``) and ``MANIFEST.json``
(a SHA-256 per file).  The JSON files are the JAX package's byte for
byte; ``log.npz`` holds the same arrays.

Crash safety: :func:`save_node_atomic` / :func:`load_latest_node` write
versioned snapshot directories with an atomically replaced ``LATEST``
pointer, so a SIGKILL mid-save can never corrupt the restore source, and
a generation that fails its manifest or its restore is quarantined and
the previous one restored.  :func:`bump_incarnation` is the boot rule
that makes restores safe in a LIVE fleet:

    A killed daemon may have minted ops after its last snapshot and
    gossiped them to peers before dying.  If the restored process reused
    its old writer id, its seq counter (restored from the snapshot) would
    re-mint (rid, seq) identities that already exist on peers with other
    timestamps, corrupting version-vector dedup and delta slicing.  So
    every boot claims a fresh incarnation k (persisted BEFORE serving: a
    crash between bump and first write just burns a number) and writes
    as wire rid = base_rid + stride * k.  The previous incarnation's ops
    are then a frozen writer prefix that flows back via ordinary gossip.

The log crosses to the host in one ``.cpu()`` under the node's lock and
then the device lock (the order every device section keeps), and comes
back with ``torch.from_numpy(...).to(node.device)``.  Not ported: the keyspace shards' sections (``ks-shard-*.json``,
``ks-reshard.json``) and ``leases.json`` (the keyspace and lease tier,
ROADMAP Queue 1 item 3): ``keyspace`` and ``leases`` must be None, and
then those files are skipped exactly as the JAX package skips them.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

MANIFEST_NAME = "MANIFEST.json"
QUARANTINE_PREFIX = "quarantine-"
LOG_COLUMNS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
TIER_NOT_PORTED = ("keyspace and lease snapshot sections are not ported "
                   "(ROADMAP Queue 1 item 3)")


def _no_tier(keyspace, leases) -> None:
    if keyspace is not None or leases is not None:
        raise NotImplementedError(TIER_NOT_PORTED)


def _interner_dump(interner) -> list:
    return [interner.lookup(i) for i in range(len(interner))]


def _interner_load(strings: list, interner) -> None:
    for s in strings:
        interner.intern(s)


def save_node(path: str, node, set_node=None, seq_node=None,
              map_node=None, composite_node=None, keyspace=None,
              leases=None) -> None:
    """Snapshot a ReplicaNode: the op-log columns, the interner tables and
    the raw command map (the gossip-serving source of truth).  Each
    sibling given adds its section: ``set_node`` / ``seq_node`` their op
    records and GC floor (the device table is rebuilt on restore),
    ``map_node`` its op records and reset epochs, ``composite_node`` its
    state dump (its snapshot IS its wire payload, so restore revalidates
    it like a gossip body).  The caller holds the node's lock (as
    :func:`save_node_atomic` does) for a consistent cut."""
    from crdt_tpu_torch.api.node import device_lock
    from crdt_tpu_torch.obs import audit as audit_mod

    _no_tier(keyspace, leases)
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    if set_node is not None:
        (p / "set.json").write_text(json.dumps(set_node.to_snapshot()))
    if seq_node is not None:
        (p / "seq.json").write_text(json.dumps(seq_node.to_snapshot()))
    if map_node is not None:
        (p / "map.json").write_text(json.dumps(map_node.to_snapshot()))
    if composite_node is not None:
        (p / "composite.json").write_text(
            json.dumps(composite_node.to_snapshot()))
    with device_lock(node.device):
        # the seven columns in one copy to the host
        host = torch.stack([getattr(node.log, name).to(torch.int32)
                            for name in LOG_COLUMNS]).cpu().numpy()
    cols = dict(zip(LOG_COLUMNS, host))
    cols["is_num"] = cols["is_num"].astype(bool)
    np.savez_compressed(p / "log.npz", **cols)
    meta = {
        "rid": node.rid,
        "alive": node.alive,
        "seq": node._seq.count,
        "epoch_ms": node.clock.epoch_ms,
        "keys": _interner_dump(node.keys),
        "values": _interner_dump(node.values),
        "commands": [
            {"ts": k[0], "rid": k[1], "seq": k[2], "cmd": v}
            for k, v in node._commands.items()
        ],
        "frontier": [[r, s] for r, s in node._frontier.items()],
        "summary": node._summary,
        # the store's digest (obs.audit): restore recomputes it from what
        # actually loaded, and a mismatch quarantines the generation
        "audit_digest": audit_mod.store_digest_hex(node),
    }
    (p / "meta.json").write_text(json.dumps(meta))


def restore_node(path: str, node, allow_rid_change: bool = False,
                 set_node=None, seq_node=None, map_node=None,
                 composite_node=None, keyspace=None, leases=None) -> None:
    """Restore a snapshot into a freshly constructed ReplicaNode.

    ``allow_rid_change=True`` is the boot-incarnation path (module
    docstring): the restoring node carries a FRESH wire rid, adopts the
    snapshot's log, commands and frontier wholesale (the old rid's ops
    become a frozen foreign-writer prefix) and keeps its own zero-based
    seq counter, since the snapshot's counter belongs to the dead
    incarnation.  The node adopts the snapshot's clock epoch: wire and
    digest timestamps are absolute, so a node booted at another epoch
    restores the same absolute state."""
    from crdt_tpu_torch.models import oplog as oplog_mod
    from crdt_tpu_torch.obs import audit as audit_mod

    _no_tier(keyspace, leases)
    p = pathlib.Path(path)
    meta = json.loads((p / "meta.json").read_text())
    rid_changed = meta["rid"] != node.rid
    if rid_changed and not allow_rid_change:
        raise AssertionError("snapshot belongs to another replica")
    with node._lock:
        _interner_load(meta["keys"], node.keys)
        _interner_load(meta["values"], node.values)
        with np.load(p / "log.npz") as z:
            node.log = oplog_mod.OpLog(**{
                name: torch.from_numpy(z[name]).to(node.device) for name in LOG_COLUMNS})
        node._log_rows = None
        # the alive flag is fault-injection state (the /condition toggle),
        # not durable data: a (re)booted replica is alive
        node.alive = True
        if not rid_changed:
            node._seq.count = meta["seq"]
        node.clock.epoch_ms = meta["epoch_ms"]
        node._commands = {
            (c["ts"], c["rid"], c["seq"]): c["cmd"] for c in meta["commands"]
        }
        node._frontier = {int(r): int(s) for r, s in meta.get("frontier", [])}
        node._summary = meta.get("summary", {})
        node._rebuild_indexes_locked()
    # the digest over what actually loaded, held against the one saved
    # with the snapshot: store corruption the SHA-256 manifest cannot see
    # (it vouches for the files, not for the load) raises, and
    # load_latest_node quarantines the generation
    want = meta.get("audit_digest")
    if want is not None:
        got = audit_mod.store_digest_hex(node)
        if got != want:
            raise ValueError(
                f"meta.json: restored state digest {got} != snapshot "
                f"digest {want} (store corrupted in the round trip)")
    if set_node is not None and (p / "set.json").exists():
        set_node.from_snapshot(json.loads((p / "set.json").read_text()))
    if seq_node is not None and (p / "seq.json").exists():
        seq_node.from_snapshot(json.loads((p / "seq.json").read_text()))
    if map_node is not None and (p / "map.json").exists():
        map_node.from_snapshot(json.loads((p / "map.json").read_text()))
    if composite_node is not None and (p / "composite.json").exists():
        # validated like a wire payload: a flipped-bit composite.json
        # raises, and the whole generation is quarantined
        composite_node.from_snapshot(
            json.loads((p / "composite.json").read_text()))


# ---- crash-safe versioned snapshots + boot incarnations ----


def _replace_file(path: pathlib.Path, data: str) -> None:
    """Atomic file write: tmp sibling + fsync + os.replace."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sha256_file(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(path: str) -> Dict[str, str]:
    """Write a per-file SHA-256 integrity manifest into snapshot dir
    ``path`` (every regular file but the manifest).  Written into the
    STAGING dir before the atomic rename, so a published snapshot always
    carries its own checksums."""
    p = pathlib.Path(path)
    files = {
        f.name: _sha256_file(f)
        for f in sorted(p.iterdir())
        if f.is_file() and f.name != MANIFEST_NAME
    }
    _replace_file(p / MANIFEST_NAME, json.dumps({"files": files}, sort_keys=True))
    return files


def verify_snapshot(path: str) -> Optional[str]:
    """Integrity-check one snapshot dir against its manifest: None when
    intact (or when it predates manifests), else a short reason."""
    p = pathlib.Path(path)
    if not p.is_dir():
        return "missing snapshot directory"
    mf = p / MANIFEST_NAME
    if not mf.is_file():
        return None  # a snapshot without a manifest: nothing to check against
    try:
        files = json.loads(mf.read_text())["files"]
    except (ValueError, KeyError, TypeError) as e:
        return f"unreadable manifest: {e}"
    for name, want in sorted(files.items()):
        f = p / name
        if not f.is_file():
            return f"manifest file missing: {name}"
        if _sha256_file(f) != want:
            return f"digest mismatch: {name}"
    return None


def _quarantine_snap(rootp: pathlib.Path, snap: pathlib.Path) -> None:
    """Move a corrupt snapshot out of the ``snap-*`` namespace (so neither
    restores nor save_node_atomic's numbering and pruning touch it again)
    while keeping it on disk for forensics."""
    if not snap.exists():
        return
    dest = rootp / f"{QUARANTINE_PREFIX}{snap.name}"
    i = 0
    while dest.exists():
        i += 1
        dest = rootp / f"{QUARANTINE_PREFIX}{snap.name}.{i}"
    try:
        snap.rename(dest)
    except OSError:
        pass  # left in place; the globs still skip a quarantined name


def save_node_atomic(root: str, node, set_node=None, seq_node=None,
                     map_node=None, composite_node=None, keyspace=None,
                     leases=None) -> str:
    """Snapshot ``node`` into a fresh versioned directory under ``root``
    and atomically repoint LATEST at it: a SIGKILL at ANY instant leaves
    the previous or the new complete snapshot as the restore source,
    never a torn one.  Holds the node's lock for a consistent cut; keeps
    the last two snapshots; returns the dir.

    The snapshot number comes from the existing snap dirs, not from
    LATEST: a kill between the rename and the LATEST repoint leaves an
    orphan snap dir ahead of LATEST, and numbering from LATEST would then
    collide with it."""
    rootp = pathlib.Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    latest = rootp / "LATEST"
    snaps = sorted(rootp.glob("snap-*"))
    n = int(snaps[-1].name.rsplit("-", 1)[-1]) + 1 if snaps else 0
    staging = rootp / f".staging-{os.getpid()}-{n}"
    shutil.rmtree(staging, ignore_errors=True)  # an orphan of a past crash
    with node._lock:
        save_node(str(staging), node, set_node=set_node, seq_node=seq_node,
                  map_node=map_node, composite_node=composite_node,
                  keyspace=keyspace, leases=leases)
    write_manifest(str(staging))
    final = rootp / f"snap-{n:08d}"
    os.rename(staging, final)  # same file system: atomic
    _replace_file(latest, final.name)
    for old in sorted(rootp.glob("snap-*"))[:-2]:
        shutil.rmtree(old, ignore_errors=True)
    for orphan in rootp.glob(".staging-*"):
        if orphan != staging:
            shutil.rmtree(orphan, ignore_errors=True)
    return str(final)


def load_latest_node(root: str, node, allow_rid_change: bool = True,
                     set_node=None, seq_node=None, map_node=None,
                     composite_node=None, keyspace=None,
                     leases=None) -> bool:
    """Restore the newest intact snapshot under ``root`` into ``node``;
    False when none restores (a fresh boot).

    Candidates: the snapshot LATEST names, then every other ``snap-*``
    dir newest first.  Each is verified against its manifest before
    restoring; one that fails verification OR restore is QUARANTINED
    (``snapshot_quarantine`` event and metric, dir renamed out of the
    snap namespace) and the next is tried.  The restore taken is recorded
    as a ``snapshot_restore`` event with its provenance."""
    _no_tier(keyspace, leases)
    rootp = pathlib.Path(root)
    latest = rootp / "LATEST"
    latest_name = latest.read_text().strip() if latest.exists() else ""
    candidates = []
    if latest_name:
        candidates.append(rootp / latest_name)
    for p in sorted(rootp.glob("snap-*"), reverse=True):
        if p.name != latest_name:
            candidates.append(p)
    for snap in candidates:
        err = verify_snapshot(str(snap))
        if err is None:
            try:
                # a failed restore may leave interner strings behind, which
                # is benign (ids are append-only); the next candidate
                # overwrites log, commands and frontier wholesale
                restore_node(str(snap), node,
                             allow_rid_change=allow_rid_change,
                             set_node=set_node, seq_node=seq_node,
                             map_node=map_node,
                             composite_node=composite_node)
            except Exception as e:  # noqa: BLE001 — quarantined loudly below
                err = f"restore failed: {type(e).__name__}: {e}"
        if err is not None:
            node.metrics.inc("snapshot_quarantines")
            node.events.emit("snapshot_quarantine", snap=snap.name,
                             reason=str(err)[:200])
            _quarantine_snap(rootp, snap)
            continue
        node.metrics.inc("snapshot_restores")
        node.events.emit(
            "snapshot_restore", snap=snap.name,
            fallback=snap.name != latest_name,
            verified=(snap / MANIFEST_NAME).is_file(),
            ks_shards=len(list(snap.glob("ks-shard-*.json"))),
        )
        return True
    return False


def bump_incarnation(root: str) -> int:
    """Claim this boot's incarnation number: read boot.json and persist
    the NEXT number (fsync'd) before returning, so no two boots of one
    checkpoint dir share an incarnation."""
    rootp = pathlib.Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    boot = rootp / "boot.json"
    k = 0
    if boot.exists():
        k = int(json.loads(boot.read_text())["incarnation"])
    _replace_file(boot, json.dumps({"incarnation": k + 1}))
    return k


def save_swarm(path: str, state: Any) -> None:
    """Snapshot a stacked swarm state (any of the port's tensor trees) as
    ``swarm.npz``, its leaves as ``leaf_{i}`` in tree order, the JAX
    package's no-orbax layout; ``treedef.json`` describes the structure."""
    from crdt_tpu_torch.utils.tree import leaves

    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    xs = leaves(state)
    np.savez_compressed(p / "swarm.npz", **{
        f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(xs)})
    (p / "treedef.json").write_text(json.dumps(
        {"type": type(state).__name__, "leaves": len(xs)}))


def restore_swarm(path: str, like: Any) -> Any:
    """Restore a swarm snapshot; ``like`` gives the tree structure and
    each leaf's device."""
    from crdt_tpu_torch.utils.tree import leaves, tree_map

    p = pathlib.Path(path)
    n = len(leaves(like))
    with np.load(p / "swarm.npz") as z:
        arrays = [z[f"leaf_{i}"] for i in range(n)]
    it = iter(arrays)
    return tree_map(lambda x: torch.from_numpy(next(it)).to(x.device), like)
