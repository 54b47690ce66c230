"""Crash-safe checkpoint/resume for the estimation pipeline.

The reference has NO mid-run recovery (SURVEY §5: worker failure kills the
whole job, `mp_handler.py:39-50`; the closest artifacts are the .tr/.MN
sumstat exports). At biobank scale a precompute pass is hours of wall
clock, so this module adds what production deployment actually needs:
periodic, atomic snapshots of the pipeline state that a fresh process can
resume from bit-exactly.

Layout of a checkpoint directory (all writes are tmp-file + os.replace,
and `meta.json` — the commit record — is always written LAST, so a crash
mid-save leaves the previous consistent state):

  meta.json            magic, config/data fingerprint, phase, next_j
  totals.npz           running (tot_XXP, tot_y) accumulators
  block_<j>.npz        per-block stats cache entries   (non-streaming)
  chunk_<j0>.npz       per-chunk stats cache entries   (non-streaming,
                                                         chunked path)
  assemble.npz         partial (T, q) samples          (streaming pass 2)
  results.npz          final float64 (T_all, q_all)    (phase "done")

Phases advance precompute -> assemble -> done; `next_j` is the first
jackknife block NOT yet covered by the stored state for the current
phase. Resume validates a fingerprint of everything that shapes the
numerics (dataset shapes + .bed identity, J/B/K, dtype, seed, model,
streaming/packed-scan modes); a mismatch starts fresh after clearing OUR
files (only files matching the names above are ever touched).
"""
from __future__ import annotations

import json
import os
import re
import zipfile

import numpy as np

_MAGIC = "pyrhe_tpu-checkpoint-v1"
# everything this module writes, including its own in-flight .tmp names,
# so reset() after a crash mid-write does not orphan temp files forever
_OURS = re.compile(
    r"^(meta\.json|totals\.npz|assemble\.npz|results\.npz|"
    r"block_\d+\.npz|chunk_\d+\.npz|shard_\d+_of_\d+\.npz)(\.tmp)?$")

# Structural corruption only: a partially-copied / truncated /
# power-lossed data file (bad zip, short read, missing key/file) means the
# stored state is unusable and resume must fall back to a fresh start.
# Transient I/O errors (stale NFS handle, EINTR, EMFILE) are deliberately
# NOT here — resetting on those would destroy hours of state that a plain
# retry would have preserved; they propagate so the operator can retry.
_LOAD_ERRORS = (zipfile.BadZipFile, KeyError, ValueError, EOFError,
                FileNotFoundError)


class CheckpointBusy(RuntimeError):
    """Another live process holds this checkpoint directory's lock."""


def _atomic_save_npz(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())   # os.replace alone is not durable
    os.replace(tmp, path)


class Checkpoint:
    def __init__(self, directory: str, fingerprint: dict, log=None,
                 lock_name: str = ".lock"):
        self.dir = directory
        self.fingerprint = fingerprint
        self.log = log
        self._lock_name = lock_name   # per-process in multi-host jobs:
        # every process of ONE job legitimately opens the shared dir, but
        # a second JOB (same process index) must still be excluded
        os.makedirs(directory, exist_ok=True)
        self._lock_fd = self._acquire_lock()
        self._pending: list = []   # staged block/chunk saves (see stage_*)
        self._meta = self._read_meta()

    # fds of directory locks this PROCESS already holds, keyed by realpath:
    # flock treats a second open in the same process as a conflicting
    # holder, but sequential resume within one process (run -> resume, or
    # the test suite) is legitimate — only OTHER live processes must be
    # excluded. Held for process lifetime; released by the OS on exit.
    _PROC_LOCKS: dict = {}

    def _acquire_lock(self):
        """Exclusive advisory lock on the directory: two simultaneous runs
        sharing one --checkpoint_dir would interleave saves/commits (and a
        config mismatch in the second would reset() the first's state from
        under it). flock is released automatically if the holder dies."""
        path = os.path.join(self.dir, self._lock_name)
        key = os.path.realpath(path)
        if key in Checkpoint._PROC_LOCKS:
            return Checkpoint._PROC_LOCKS[key]
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass   # non-POSIX: no advisory locking available
        except OSError as e:
            import errno
            if e.errno in (errno.EWOULDBLOCK, errno.EAGAIN, errno.EACCES):
                os.close(fd)
                raise CheckpointBusy(
                    f"checkpoint directory {self.dir} is locked by another "
                    "live run; refusing to share it")
            # flock unsupported on this filesystem (ENOTSUP/ENOLCK on some
            # NFS/overlay mounts): proceed unlocked rather than misreport
            # the run as busy and silently lose checkpointing entirely
            if self.log is not None:
                self.log._log(
                    f"Note: advisory locking unavailable on {self.dir} "
                    f"({e}); proceeding without a checkpoint lock")
        Checkpoint._PROC_LOCKS[key] = fd
        return fd

    # ---------------------------------------------------------------- meta
    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _read_meta(self):
        """Load and validate meta.json; on any mismatch, clear our files
        and start fresh (returns None)."""
        path = self._path("meta.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            meta = {}
        if (meta.get("magic") != _MAGIC
                or meta.get("fingerprint") != self.fingerprint):
            if self.log is not None:
                self.log._log(
                    f"Note: checkpoint in {self.dir} does not match this "
                    "run's configuration/dataset; starting fresh")
            self.reset()
            return None
        return meta

    def reset(self) -> None:
        """Remove every file this module could have written (and nothing
        else — the directory may be shared)."""
        for name in os.listdir(self.dir):
            if _OURS.match(name):
                os.remove(self._path(name))
        self._meta = None

    def state(self):
        """(phase, next_j) of the stored state, or None if starting fresh."""
        if self._meta is None:
            return None
        return self._meta["phase"], int(self._meta["next_j"])

    def commit(self, phase: str, next_j: int) -> None:
        """Atomically record that all data files for `phase` up to block
        `next_j` are on disk. Flushes staged block/chunk saves first so a
        committed meta never points at data files that were not written."""
        self.flush_pending()
        meta = {"magic": _MAGIC, "fingerprint": self.fingerprint,
                "phase": phase, "next_j": int(next_j)}
        tmp = self._path("meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path("meta.json"))
        self._meta = meta

    def _load_or_reset(self, loader):
        """Run a load; on any corruption (missing/truncated data file from
        a partial directory copy or power loss) log, clear our state, and
        return the start-fresh sentinel instead of crashing."""
        try:
            return loader()
        except _LOAD_ERRORS as e:
            if self.log is not None:
                self.log._log(
                    f"Note: checkpoint in {self.dir} is missing or corrupt "
                    f"({type(e).__name__}: {e}); starting fresh")
            self.reset()
            return None

    # ------------------------------------------------------------- payloads
    # Data files are SELF-DESCRIBING (they carry their own next_j) because
    # a crash between a data save and the meta commit leaves the file one
    # interval AHEAD of meta; resume trusts the file's next_j (its content
    # matches it by construction — block/chunk files are saved before the
    # totals that cover them), while meta gates fingerprint and phase.
    def save_totals(self, tot_XXP, tot_y, next_j: int) -> None:
        # data files before the totals that cover them (resume invariant)
        self.flush_pending()
        _atomic_save_npz(self._path("totals.npz"),
                         tot_XXP=np.asarray(tot_XXP),
                         tot_y=np.asarray(tot_y), next_j=np.int64(next_j))

    def load_totals(self):
        """(tot_XXP, tot_y, next_j), or None if no totals were saved."""
        path = self._path("totals.npz")
        if not os.path.exists(path):
            return None

        def _load():
            with np.load(path) as z:
                return z["tot_XXP"], z["tot_y"], int(z["next_j"])
        return self._load_or_reset(_load)

    # Per-block/chunk stats are STAGED, not written immediately: the
    # cadence flag (--checkpoint_every) must throttle the dominant
    # checkpoint I/O (the stats slabs), not just the small totals/meta
    # writes. Staged entries keep the arrays referenced (they live in the
    # engine's stats cache anyway) and are flushed by save_totals/commit.
    def stage_block(self, j: int, XXP, yXXy) -> None:
        self._pending.append(("block", (j, XXP, yXXy)))

    def stage_chunk(self, j0: int, C: int, Xs, Ys) -> None:
        self._pending.append(("chunk", (j0, C, Xs, Ys)))

    def flush_pending(self) -> None:
        for kind, payload in self._pending:
            if kind == "block":
                j, XXP, yXXy = payload
                _atomic_save_npz(self._path(f"block_{j:06d}.npz"),
                                 XXP=np.asarray(XXP), yXXy=np.asarray(yXXy))
            else:
                j0, C, Xs, Ys = payload
                _atomic_save_npz(self._path(f"chunk_{j0:06d}.npz"),
                                 j0=np.int64(j0), C=np.int64(C),
                                 Xs=np.asarray(Xs), Ys=np.asarray(Ys))
        self._pending.clear()

    def load_blocks_partial(self, upto: int):
        """{j: (XXP, yXXy)} for whichever block files < upto exist and
        load. A missing or corrupt file is simply skipped instead of
        resetting state: under a cache_limit only the budgeted blocks
        were ever staged, and pass 2 recomputes any hole through
        _loo_stats' cache-miss branch."""
        out = {}
        for j in range(upto):
            path = self._path(f"block_{j:06d}.npz")
            if not os.path.exists(path):
                continue
            try:
                with np.load(path) as z:
                    out[j] = (z["XXP"], z["yXXy"])
            except _LOAD_ERRORS:
                continue
        return out

    def load_chunks_prefix(self, upto: int):
        """[(j0, C, Xs, Ys)] for the longest loadable prefix of chunk
        files covering blocks [0, upto). A missing or corrupt file just
        ENDS the prefix instead of resetting state: under the hybrid
        cache only the HBM-budgeted chunks have files on disk, and the
        remainder is legitimately recomputed in pass 2."""
        chunks, j = [], 0
        while j < upto:
            path = self._path(f"chunk_{j:06d}.npz")
            if not os.path.exists(path):
                break
            try:
                with np.load(path) as z:
                    C = int(z["C"])
                    chunks.append((j, C, z["Xs"], z["Ys"]))
            except _LOAD_ERRORS:
                break
            j += C
        return chunks

    def save_assemble(self, T_part, q_part, next_j: int) -> None:
        _atomic_save_npz(self._path("assemble.npz"),
                         T=np.asarray(T_part), q=np.asarray(q_part),
                         next_j=np.int64(next_j))

    def load_assemble(self):
        """(T_part, q_part, next_j), or None if nothing was saved."""
        path = self._path("assemble.npz")
        if not os.path.exists(path):
            return None

        def _load():
            with np.load(path) as z:
                return z["T"], z["q"], int(z["next_j"])
        return self._load_or_reset(_load)

    def save_results(self, T_all, q_all) -> None:
        _atomic_save_npz(self._path("results.npz"),
                         T_all=np.asarray(T_all, np.float64),
                         q_all=np.asarray(q_all, np.float64))

    def load_results(self):
        """(T_all, q_all), or None (state cleared) if missing/corrupt."""
        def _load():
            with np.load(self._path("results.npz")) as z:
                return z["T_all"], z["q_all"]
        return self._load_or_reset(_load)
