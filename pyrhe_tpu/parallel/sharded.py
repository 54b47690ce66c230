"""Unified multi-device / multi-host execution of the RHE two-pass
pipeline: jackknife blocks sharded over a 1-D "jack" mesh axis, streamed
through the devices in chunks of cleaned packed bytes, and any jackknife
count J.

This replaces the reference's only parallelism — jackknife blocks fanned
out to processes over POSIX shared memory (reference base.py:432-437,
530-544, mp_handler.py:27-37, and the streaming worker loop
base_streaming.py:85-144) — across the cards of one or more hosts:

  ownership   J is padded to J_pad = D * J_loc with zero blocks (they
              standardize to zero columns and contribute nothing); device
              d owns the contiguous slot range [d*J_loc, (d+1)*J_loc).
  pass 1      S supersteps; in superstep s every device runs a jitted
              lax.scan over C of its blocks (fused decode+matmul stats),
              accumulating a device-local partial total. Each process
              stages ONLY its own devices' .bed byte ranges
              (jax.make_array_from_process_local_data), one superstep
              ahead of the device on a background thread.
  merge       one cross-device reduction of the (E, N, b2) partial totals
              (an XLA all-reduce over the device interconnect).
  pass 2      per superstep, the leave-one-out normal equations for the
              owned blocks assemble on the owning device
              (assemble_Tq_chunk_core under shard_map). Streaming mode
              re-stages and recomputes each chunk's stats inside the same
              dispatch instead of caching pass 1's — per-device memory is
              O(C) blocks, independent of J (the reference's two-pass
              StreamingBase design, with the disk re-read overlapped).
  replicate   the (J+1) tiny T/q systems are all-gathered and the solves
              run replicated on every host.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.normal_eq import assemble_Tq_chunk_core


def owned_rows(sharding: NamedSharding, global_rows: int) -> list[int]:
    """Global row indices this PROCESS owns under a leading-axis sharding,
    in the order make_array_from_process_local_data expects the local
    slab to be laid out (ascending global offset)."""
    idx_map = sharding.addressable_devices_indices_map((global_rows,))
    spans = sorted((sl[0].start or 0, sl[0].stop or global_rows)
                   for sl in idx_map.values())
    out: list[int] = []
    for start, stop in spans:
        out.extend(range(start, stop))
    return out


@dataclass
class _Plan:
    D: int          # devices on the jack axis
    C: int          # blocks per device per superstep
    S: int          # supersteps
    J_loc: int      # S * C slots per device
    J_pad: int      # D * J_loc total slots (>= J)
    m_pad: int      # uniform padded SNP rows per block
    W: int          # staged byte/dosage width per SNP row


class ShardedRunner:
    """Drives an Engine's precompute+assemble over a device mesh.

    Every process must construct the same Engine (same files, same config)
    and call run(); single-process multi-device and multi-process
    (jax.distributed) execution take the same path.
    """

    def __init__(self, engine, mesh: Mesh, axis: str = "jack"):
        self.eng = engine
        self.mesh = mesh
        self.axis = axis
        self.sh_block = NamedSharding(mesh, P(axis))
        self.sh_repl = NamedSharding(mesh, P())
        self.plan = self._make_plan()

    # ------------------------------------------------------------- planning
    def _make_plan(self) -> _Plan:
        eng = self.eng
        D = int(self.mesh.devices.size)
        d = eng.data
        step = d.num_snp // eng.J
        max_m = step + (d.num_snp - step * eng.J)   # last block + remainder
        m_pad = max_m
        W = (d.bed.bytes_per_snp
             if eng.packed_scan or d.bed.keep_idx is None else d.num_indv)
        per_dev = -(-eng.J // D)                     # ceil(J / D)
        # staging budget per superstep per device: ~256 MB of packed bytes
        C = int(max(1, min(per_dev, 256e6 // max(m_pad * W, 1))))
        S = -(-per_dev // C)                         # ceil(per_dev / C)
        J_loc = S * C
        return _Plan(D=D, C=C, S=S, J_loc=J_loc, J_pad=D * J_loc,
                     m_pad=m_pad, W=W)

    # -------------------------------------------------------------- staging
    def _stage_block(self, slot: int, np_dt):
        """Host-side staging of one slot: (geno (m_pad, W) u8, fill
        (m_pad,) f32, annot (m_pad, K)). Padding slots (slot >= J) are all
        zeros — they decode to zero dosage, zero variance, zero stats."""
        eng = self.eng
        pl = self.plan
        annot = np.zeros((pl.m_pad, eng.K), np_dt)
        if slot < eng.J:
            s0, e0 = eng._block_range(slot)
            annot[:e0 - s0] = eng.data.annot[s0:e0].astype(np_dt)
        # host-RAM packed cache: streaming pass 2 restages this process's
        # slots from memory instead of re-reading the .bed (engine
        # _init_host_cache; keyed separately from the sequential path)
        if eng._packed_cache is not None:
            hit = eng._packed_cache.get(("sh", slot))
            if hit is not None:
                eng._phase_add("host_cache_hits", 1.0)
                return hit[0], hit[1], annot
        geno = np.zeros((pl.m_pad, pl.W), np.uint8)
        fill = np.zeros(pl.m_pad, np.float32)
        if slot >= eng.J:
            return geno, fill, annot
        s, e = eng._block_range(slot)
        m = e - s
        d = eng.data
        if eng.packed_scan or d.bed.keep_idx is None:
            # packed path: with packed_scan this also covers FILTERED
            # data (packed_col_stats subtracts dropped individuals, and
            # the full population is decoded under valid_mask — see
            # Engine._setup_layout)
            from ..io.bed import clean_packed
            packed = d.bed.read_packed_block(s, e)
            if eng.cfg.geno_impute_method == "binary":
                sums, nmiss = d.bed.packed_col_stats(packed)
                f = eng._fill_from_stats(sums, nmiss, d.num_indv, m)
            else:
                f = np.zeros(m)
            # integral fills are rewritten into the packed bytes, so the
            # device decode meets no missing code
            clean_packed(packed, f, out=geno)
        else:
            g = d.bed.read_block(s, e)
            if eng.cfg.geno_impute_method == "binary":
                sums, nmiss = d.bed.col_stats(g)
                fill[:m] = eng._fill_from_stats(sums, nmiss, g.shape[1], m)
            geno[:m, :g.shape[1]] = g
        if eng._packed_cache is not None:
            eng._packed_cache[("sh", slot)] = (geno, fill)
        return geno, fill, annot

    def _row_slot(self, s: int, r: int) -> int:
        """Global slot for row r of superstep s's (D*C)-row chunk."""
        dev, t = divmod(r, self.plan.C)
        return dev * self.plan.J_loc + s * self.plan.C + t

    def _stage_superstep(self, s: int, np_dt):
        """Assemble THIS PROCESS's slab for superstep s and build the
        global sharded chunk arrays (D*C leading rows)."""
        eng = self.eng
        pl = self.plan
        t0 = time.perf_counter()
        genos, fills, annots = [], [], []
        for r in owned_rows(self.sh_block, pl.D * pl.C):
            g, f, a = self._stage_block(self._row_slot(s, r), np_dt)
            genos.append(g)
            fills.append(f)
            annots.append(a)
        eng._phase_add("host_read_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        mk = partial(jax.make_array_from_process_local_data, self.sh_block)
        gshape = (pl.D * pl.C,)
        gstack = np.stack(genos)
        out = (mk(gstack, gshape + gstack.shape[1:]),
               mk(np.stack(fills), gshape + fills[0].shape),
               mk(np.stack(annots), gshape + annots[0].shape))
        jax.block_until_ready(out)           # count transfer, not enqueue
        # thread-seconds across concurrent staging streams (see
        # Engine._chunked_stats_stream); stage_bytes / wall = effective rate
        eng._phase_add("stage_s", time.perf_counter() - t0)
        eng._phase_add("stage_bytes",
                       float(sum(x.size * x.dtype.itemsize for x in out)))
        return out

    def _staged_supersteps(self, start_s: int = 0,
                           stop_s: int | None = None):
        """Yield (s, staged chunk) for supersteps [start_s, stop_s) with up to
        `depth` host->device transfers in flight (the sequential engine's
        chunk pipeline, Engine._stage_depth)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        np_dt = np.float64 if self.eng.dtype == jnp.float64 else np.float32
        depth = self.eng._stage_depth()
        steps = iter(range(start_s, self.plan.S if stop_s is None
                           else stop_s))
        with ThreadPoolExecutor(max_workers=depth) as ex:
            pending: deque = deque()

            def refill():
                while len(pending) < depth:
                    try:
                        s = next(steps)
                    except StopIteration:
                        return
                    pending.append((s, ex.submit(self._stage_superstep, s,
                                                 np_dt)))

            refill()
            while pending:
                s, fut = pending.popleft()
                chunk = fut.result()
                refill()
                yield s, chunk

    # --------------------------------------------------------- checkpointing
    # Multi-card multi-hour runs are exactly where crash-safety matters, so
    # the sharded path snapshots per PROCESS: each process writes its own
    # addressable shard slabs under <checkpoint_dir>/shard_<pid>_of_<n>/,
    # fingerprint-gated like the sequential path plus the superstep plan
    # (a changed mesh/chunking re-partitions slots, so stored slabs only
    # resume under the same plan). Units are SUPERSTEPS, not blocks.
    def _make_ckpt(self, s_keep: int):
        eng = self.eng
        if not eng.cfg.checkpoint_dir:
            return None
        from ..core.checkpoint import Checkpoint, CheckpointBusy
        pid, n = jax.process_index(), jax.process_count()
        sub = os.path.join(eng.cfg.checkpoint_dir, f"shard_{pid}_of_{n}")
        pl = self.plan
        fp = dict(eng._fingerprint())
        fp.update({"sharded_plan": [pl.D, pl.C, pl.S, pl.J_loc, pl.J_pad],
                   # the cache split (s_keep) is deliberately NOT part of
                   # the fingerprint: stats content does not depend on it,
                   # and the tolerant prefix load + recompute walk make a
                   # checkpoint written under one split resumable under
                   # any other (only throughput differs)
                   "process": [pid, n]})
        try:
            return Checkpoint(sub, fp, eng.log)
        except CheckpointBusy as e:
            eng.log._log(f"WARNING: {e}; sharded run will NOT checkpoint")
            return None

    def _local_slab(self, arr) -> np.ndarray:
        """This process's rows of a leading-axis-sharded global array as
        one host array, ascending global offset (the layout
        make_array_from_process_local_data rebuilds from)."""
        shards = sorted(arr.addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        return np.concatenate([np.asarray(sh.data) for sh in shards])

    def _from_slab(self, slab, global_shape):
        return jax.make_array_from_process_local_data(
            self.sh_block, np.asarray(slab), tuple(global_shape))

    def _ckpt_pass1_state(self, ck, s_keep, totX, toty, cache):
        """Resume bookkeeping for pass 1. Returns (start_s, totX, toty)
        and refills the `cache` dict with per-superstep stats arrays
        re-staged from the local slabs — tolerant prefix load: under the
        hybrid split only supersteps < s_keep have slab files, and a
        shorter-than-expected prefix just means pass 2 recomputes more."""
        if ck is None:
            return 0, totX, toty
        st = ck.state()
        if st is None:
            return 0, totX, toty
        ld = ck.load_totals()
        if ld is None:
            return 0, totX, toty
        phase, _ = st
        start_s = self.plan.S if phase in ("assemble", "done") else ld[2]
        if start_s <= 0:
            return 0, totX, toty
        pl, eng = self.plan, self.eng
        if s_keep > 0:
            T_traits = max(eng.T_traits, 0)
            for s, _C, bX, by in ck.load_chunks_prefix(
                    min(start_s, s_keep)):
                cache[s] = (
                    self._from_slab(bX, (pl.D * pl.C, eng.E_geno,
                                         eng.N_work, eng.b2)),
                    self._from_slab(by, (pl.D * pl.C, eng.E_geno,
                                         T_traits)))
        totX = self._from_slab(ld[0], totX.shape)
        toty = self._from_slab(ld[1], toty.shape)
        eng.log._log(
            f"Resuming sharded precompute from checkpoint: {start_s}/"
            f"{pl.S} supersteps already covered ({ck.dir})")
        return start_s, totX, toty

    def _ckpt_pass2_state(self, ck, Ts, qs, Ts_loc, qs_loc) -> int:
        """Resume bookkeeping for pass 2: reloads the per-superstep local
        (T, q) slabs, rebuilds their sharded arrays, and returns the first
        superstep still to assemble."""
        if ck is None:
            return 0
        st = ck.state()
        if st is None or st[0] not in ("assemble", "done"):
            return 0
        ld = ck.load_assemble()
        if ld is None:
            return 0
        T_slabs, q_slabs, next_s = ld   # (next_s, local_rows, ...)
        if next_s <= 0:
            return 0
        rows = self.plan.D * self.plan.C
        for i in range(next_s):
            Ts.append(self._from_slab(T_slabs[i],
                                      (rows,) + T_slabs.shape[2:]))
            qs.append(self._from_slab(q_slabs[i],
                                      (rows,) + q_slabs.shape[2:]))
            Ts_loc.append(T_slabs[i])
            qs_loc.append(q_slabs[i])
        self.eng.log._log(
            f"Resuming sharded assemble from checkpoint: {next_s}/"
            f"{self.plan.S} supersteps already built")
        return next_s

    def _superstep_M_rows(self, s: int):
        """Sharded leave-one-out M rows for superstep s's slots (padding
        slots get the full-genome row — their T/q output is dropped)."""
        pl = self.plan
        eng = self.eng
        rows = owned_rows(self.sh_block, pl.D * pl.C)
        out = np.zeros((len(rows), eng.E), np.int64)
        for i, r in enumerate(rows):
            slot = self._row_slot(s, r)
            out[i] = eng.M_mat[min(slot, eng.J)]
        return jax.make_array_from_process_local_data(
            self.sh_block, out, (pl.D * pl.C, eng.E))

    def _replicated(self, x, dtype=None):
        arr = np.asarray(x)
        if dtype is not None:
            arr = arr.astype(dtype)
        return jax.make_array_from_process_local_data(self.sh_repl, arr,
                                                      arr.shape)

    # ---------------------------------------------------------- step builds
    def _stat_core(self):
        """Uniform per-block stats fn(geno, fill, annot, P, env, mask)."""
        eng = self.eng
        if eng.packed_scan:
            stats = eng._scan_stats_fn()

            def core(g, f, a, P_mat, env, mask):
                return stats(g, a, P_mat, env, mask)
        else:
            from ..ops.moments import block_stats_core
            kw = dict(n_indiv=eng.data.num_indv,
                      components=eng.spec.components, b2=eng.b2,
                      packed=(eng.data.bed.keep_idx is None),
                      dtype=eng.dtype, mm_mode=eng.mm_mode)

            def core(g, f, a, P_mat, env, mask):
                return block_stats_core(g, f.astype(eng.dtype), a, P_mat,
                                        env, **kw)
        return core

    def _scan_stats(self, core, chunk, P_mat, env, mask, totX, toty, keep):
        def body(carry, xs):
            g, f, a = xs
            XXP, yXXy, _ = core(g, f, a, P_mat, env, mask)
            out = (XXP, yXXy) if keep else 0
            return (carry[0] + XXP, carry[1] + yXXy), out

        return jax.lax.scan(body, (totX, toty), chunk)

    def _build_steps(self):
        """Jitted global functions (all variants; jit compiles lazily so
        only the ones the cache split actually dispatches cost anything):

        stats_keep/stats_drop: pass 1 superstep — per-device scan,
            carried partial totals; `keep` additionally returns the
            per-block stats slab for the HBM cache
        asm_cached: pass 2 superstep from a cached slab
        asm_recomp: pass 2 superstep recomputing the slab's stats inside
            the dispatch from re-staged bytes
        finalize:   partial-totals reduction -> replicated grand totals
        """
        eng = self.eng
        core = self._stat_core()
        asm_kw = dict(num_random_vec=eng.B, n_indiv=eng.data.num_indv,
                      n_cov=eng.data.cov.shape[1] if eng.use_cov else 0)
        use_cov = eng.use_cov
        blk, repl = P(self.axis), P()
        smap = partial(jax.shard_map, mesh=self.mesh, check_vma=False)

        def make_stats(keep):
            def stats_body(geno_c, fill_c, annot_c, totX, toty, P_mat,
                           env, mask):
                # per-device views: geno_c (C, m_pad, W); totX (1,E,N,b2)
                (tX, ty), ys = self._scan_stats(
                    core, (geno_c, fill_c, annot_c), P_mat, env, mask,
                    totX[0], toty[0], keep=keep)
                if not keep:
                    return tX[None], ty[None]
                return tX[None], ty[None], ys

            return jax.jit(smap(
                stats_body,
                in_specs=(blk, blk, blk, blk, blk, repl, repl, repl),
                out_specs=(blk, blk, blk) if keep else (blk, blk)),
                donate_argnums=(3, 4))

        def asm_tail(bX, by, M_rows, totX, toty, nxeX, nxey, Z, Uzb, C_mat,
                     Q, q_last, stoch):
            return assemble_Tq_chunk_core(
                totX, toty, bX, by, M_rows, nxeX, nxey, Z, Uzb,
                C_mat if use_cov else None, Q if use_cov else None,
                q_last, stoch, **asm_kw)

        def make_asm_recomp():
            def asm_body(geno_c, fill_c, annot_c, M_rows, totX, toty, nxeX,
                         nxey, Z, Uzb, C_mat, Q, q_last, stoch, P_mat, env,
                         mask):
                _, (bX, by) = self._scan_stats(
                    core, (geno_c, fill_c, annot_c), P_mat, env, mask,
                    jnp.zeros_like(totX), jnp.zeros_like(toty), keep=True)
                return asm_tail(bX, by, M_rows, totX, toty, nxeX, nxey, Z,
                                Uzb, C_mat, Q, q_last, stoch)

            return jax.jit(smap(
                asm_body,
                in_specs=(blk, blk, blk, blk) + (repl,) * 13,
                out_specs=(blk, blk)))

        def make_asm_cached():
            def asm_body(bX, by, M_rows, totX, toty, nxeX, nxey, Z, Uzb,
                         C_mat, Q, q_last, stoch):
                return asm_tail(bX, by, M_rows, totX, toty, nxeX, nxey, Z,
                                Uzb, C_mat, Q, q_last, stoch)

            return jax.jit(smap(
                asm_body,
                in_specs=(blk, blk, blk) + (repl,) * 10,
                out_specs=(blk, blk)),
                donate_argnums=(0, 1))

        # all four are built unconditionally: jit compiles lazily, so the
        # unused variants cost nothing, and a resume whose cache prefix
        # loaded short may need asm_recomp even when s_keep == S
        stats_keep = make_stats(True)
        stats_drop = make_stats(False)
        asm_cached = make_asm_cached()
        asm_recomp = make_asm_recomp()

        finalize = jax.jit(
            lambda tX, ty: (tX.sum(0), ty.sum(0)),
            out_shardings=(self.sh_repl, self.sh_repl))

        full_sample = jax.jit(asm_tail)
        return (stats_keep, stats_drop, asm_cached, asm_recomp, finalize,
                full_sample)

    # ------------------------------------------------------------------ run
    def run(self):
        """Execute both passes; returns (T_all, q_all) float64 host arrays
        of shape (J+1, E+1, E+1) / (J+1, E+1, T) on every process."""
        eng = self.eng
        pl = self.plan
        s_keep = self._cache_supersteps()
        ck = self._make_ckpt(s_keep)
        if ck is not None:
            st = ck.state()
            if st is not None and st[0] == "done":
                res = ck.load_results()
                if res is not None:
                    eng.log._log(
                        "Resumed completed (T, q) from sharded checkpoint "
                        f"({ck.dir}); skipping both passes")
                    return res
        every = max(1, eng.cfg.checkpoint_every)
        (stats_keep, stats_drop, asm_cached, asm_recomp, finalize,
         full_sample) = self._build_steps()

        # replicated small arrays
        P_mat = self._replicated(eng.P)
        env = self._replicated(eng._env_arg())
        mask = self._replicated(eng.valid_mask)
        Z, Uzb = self._replicated(eng.Zd), self._replicated(eng.Uzbd)
        C_mat = self._replicated(
            eng.Cd if eng.use_cov else jnp.zeros((eng.N_work, 1), eng.dtype))
        Q = self._replicated(
            eng.Qd if eng.use_cov else jnp.zeros((1, 1), eng.dtype))
        q_last = self._replicated(eng.q_last)
        stoch = self._replicated(eng.stoch_mask)
        T_traits = max(eng.T_traits, 0)
        nxeX = self._replicated(
            eng.nxe_XXP if eng.num_nxe
            else jnp.zeros((0, eng.N_work, eng.b2), eng.dtype))
        nxey = self._replicated(
            eng.nxe_yXXy if eng.num_nxe
            else jnp.zeros((0, T_traits), eng.dtype))
        small = (nxeX, nxey, Z, Uzb, C_mat, Q, q_last, stoch)

        totX = jax.device_put(
            jnp.zeros((pl.D, eng.E_geno, eng.N_work, eng.b2), eng.dtype),
            self.sh_block)
        toty = jax.device_put(
            jnp.zeros((pl.D, eng.E_geno, T_traits), eng.dtype),
            self.sh_block)

        # ---- pass 1: supersteps, concurrent staging streams ---------------
        cache: dict = {}     # s -> (bX, by) for the s_keep cached supersteps
        start_s, totX, toty = self._ckpt_pass1_state(ck, s_keep, totX,
                                                     toty, cache)
        for s, chunk in self._staged_supersteps(start_s):
            keep_s = s < s_keep
            t0 = time.perf_counter()
            step = stats_keep if keep_s else stats_drop
            out = step(*chunk, totX, toty, P_mat, env, mask)
            totX, toty = out[0], out[1]
            if keep_s:
                cache[s] = out[2]
            del chunk
            eng._phase_add("scan_dispatch_s", time.perf_counter() - t0)
            if ck is not None:
                if keep_s:
                    ck.stage_chunk(s, 1, self._local_slab(out[2][0]),
                                   self._local_slab(out[2][1]))
                    # flush immediately: unlike the sequential path, these
                    # slabs are FRESH host copies (not views of the engine's
                    # stats cache), so letting the cadence accumulate them
                    # in _pending would hold up to `every` GB-sized slabs
                    # in host RAM. Each chunk file is written exactly once
                    # either way; the cadence gates only totals/meta.
                    ck.flush_pending()
                if (s + 1 - start_s) % every == 0:
                    ck.save_totals(self._local_slab(totX),
                                   self._local_slab(toty), s + 1)
                    ck.commit("precompute", s + 1)
            eng.log._debug(f"sharded superstep {s + 1}/{pl.S} done")
        if ck is not None and start_s < pl.S:
            ck.save_totals(self._local_slab(totX), self._local_slab(toty),
                           pl.S)
            ck.commit("assemble", 0)
        totX_r, toty_r = finalize(totX, toty)

        # ---- pass 2: per-superstep leave-one-out assembly -----------------
        Ts, qs = [], []
        Ts_loc: list = []   # host slab copies mirroring Ts (checkpointing)
        qs_loc: list = []
        start2 = self._ckpt_pass2_state(ck, Ts, qs, Ts_loc, qs_loc)

        def _ckpt_pass2_save(s):
            Ts_loc.append(self._local_slab(Ts[-1]))
            qs_loc.append(self._local_slab(qs[-1]))
            if (s + 1 - start2) % every == 0:
                ck.save_assemble(np.stack(Ts_loc), np.stack(qs_loc), s + 1)
                ck.commit("assemble", s + 1)

        # Walk supersteps in order: cached ones assemble from their HBM
        # slabs (popped so peak memory stays at one cache copy); gaps —
        # the unkept hybrid tail, or cache entries a resume could not
        # reload — recompute their stats inside the dispatch from
        # re-staged bytes. s_keep == S is the pure cached mode, 0 pure
        # streaming, in between the HYBRID split; per-superstep stats are
        # identical whichever pass computes them, so the estimates are
        # bit-identical across all three.
        s = start2
        while s < pl.S:
            if s in cache:
                bX, by = cache.pop(s)
                T_c, q_c = asm_cached(bX, by, self._superstep_M_rows(s),
                                      totX_r, toty_r, *small)
                Ts.append(T_c)
                qs.append(q_c)
                if ck is not None:
                    _ckpt_pass2_save(s)
                s += 1
            else:
                stop = min((k for k in cache if k > s), default=pl.S)
                for s2, chunk in self._staged_supersteps(s, stop):
                    t0 = time.perf_counter()
                    T_c, q_c = asm_recomp(*chunk,
                                          self._superstep_M_rows(s2),
                                          totX_r, toty_r, *small, P_mat,
                                          env, mask)
                    Ts.append(T_c)
                    qs.append(q_c)
                    del chunk
                    eng._phase_add("scan_dispatch_s",
                                   time.perf_counter() - t0)
                    if ck is not None:
                        _ckpt_pass2_save(s2)
                s = stop

        # full-data sample: zero block against the totals
        dummyX = self._replicated(
            jnp.zeros((1, eng.E_geno, eng.N_work, eng.b2), eng.dtype))
        dummyy = self._replicated(
            jnp.zeros((1, eng.E_geno, T_traits), eng.dtype))
        M_full = self._replicated(eng.M_mat[eng.J:].astype(np.int64))
        T_full, q_full = full_sample(dummyX, dummyy, M_full, totX_r,
                                     toty_r, *small)

        # ---- gather: replicate the tiny T/q systems on every host --------
        gather = jax.jit(lambda *xs: jnp.concatenate(xs),
                         out_shardings=self.sh_repl)
        T_pad = np.asarray(gather(*Ts), np.float64)
        q_pad = np.asarray(gather(*qs), np.float64)
        J = eng.J
        T_all = np.zeros((J + 1,) + T_pad.shape[1:], np.float64)
        q_all = np.zeros((J + 1,) + q_pad.shape[1:], np.float64)
        for s in range(pl.S):
            for r in range(pl.D * pl.C):
                slot = self._row_slot(s, r)
                if slot < J:
                    T_all[slot] = T_pad[s * pl.D * pl.C + r]
                    q_all[slot] = q_pad[s * pl.D * pl.C + r]
        T_all[J] = np.asarray(T_full, np.float64)[0]
        q_all[J] = np.asarray(q_full, np.float64)[0]
        if ck is not None:
            ck.save_results(T_all, q_all)
            ck.commit("done", pl.S)
        return T_all, q_all

    def _cache_supersteps(self) -> int:
        """Supersteps whose per-device stats slabs pass 1 may keep in HBM:
        plan.S = full cache, 0 = streaming, in between = HYBRID (pass 2
        recomputes only the unkept tail — the sharded twin of the
        engine's cache_limit; see Engine.__init__ cache sizing)."""
        eng = self.eng
        pl = self.plan
        if eng.cfg.streaming:
            return 0
        if eng.cfg.cache_blocks >= 0:
            # explicit per-device block budget (--cache_blocks)
            s_keep = max(0, min(pl.S, eng.cfg.cache_blocks // pl.C))
            if s_keep < pl.S:
                eng.log._log(
                    f"Note: sharded stats cache capped at {s_keep}/"
                    f"{pl.S} supersteps (--cache_blocks); the rest is "
                    "recomputed in pass 2 (hybrid)")
            return s_keep
        dsize = 8 if eng.dtype == jnp.float64 else 4
        per_block = eng.E_geno * eng.N_work * eng.b2 * dsize
        cache_bytes = pl.J_loc * per_block
        if eng._dev.platform == "cpu" or cache_bytes <= eng._hbm_budget():
            return pl.S
        # same ~4-block working-set reserve as the sequential engine
        fit = int(eng._hbm_budget() // per_block) - 4
        s_keep = max(0, min(pl.S, fit // pl.C))
        eng.log._log(
            f"Note: per-device stats cache (~{cache_bytes / 1e9:.1f} GB) "
            f"exceeds the device budget; caching {s_keep}/{pl.S} "
            "supersteps and recomputing the rest in pass 2"
            + (" (streaming)" if s_keep == 0 else " (hybrid)"))
        return s_keep
