"""The RHE estimation engine.

Orchestrates the whole method-of-moments pipeline over jackknife blocks:

  pass 1   for each SNP block j: host .bed read (packed bytes or decoded
           u8) -> device block_stats (decode+impute+standardize+fused
           matmuls) -> accumulate totals; optionally cache per-block stats.
  pass 2   per-sample leave-one-out stats (total - block) -> device
           assemble_Tq -> (J+1) small (E+1)x(E+1) systems on host.
  solve    QR/lstsq per sample + jackknife SEs + h2/enrichment.

Streaming mode (cfg.streaming) recomputes block stats in pass 2 instead of
caching them — O(E*N*B) memory independent of J, the reference's
StreamingBase two-pass design (base_streaming.py:85-144) without the
disk-re-read being the bottleneck (decode runs on device).

Unlike the reference (which reruns everything per trait, base.py:874-886),
all traits share one precompute: every trait's residualized phenotype is an
extra probe column, so T is computed once and only q differs per trait.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.moments import block_stats, block_stats_core, nxe_stats
from ..utils.logger import Logger
from .data import DataBundle
from .normal_eq import assemble_Tq
from . import solver as S


@dataclass(frozen=True)
class ModelSpec:
    """Which variance components to estimate.

    components: tuple of (kind, env_idx) per genotype-backed component,
    kind in {"add", "dom"}; each contributes num_bin estimate rows.
    include_nxe appends num_env analytic hetero-noise rows.
    Estimate ordering matches the reference's (with the corrected GxE
    indexing k_gxe = num_bin + e*num_bin + k, see SURVEY §2.6).
    """
    model: str
    genie_model: str = "G"
    components: tuple = (("add", None),)
    num_env: int = 0
    include_nxe: bool = False

    @staticmethod
    def build(model: str, genie_model: str = "G", num_env: int = 0):
        if model == "rhe":
            return ModelSpec("rhe", components=(("add", None),))
        if model == "rhe_dom":
            return ModelSpec("rhe_dom",
                             components=(("add", None), ("dom", None)))
        if model == "genie":
            comps = [("add", None)]
            include_nxe = False
            if genie_model in ("G+GxE", "G+GxE+NxE"):
                comps += [("add", e) for e in range(num_env)]
            if genie_model == "G+GxE+NxE":
                include_nxe = True
            elif genie_model not in ("G", "G+GxE"):
                raise ValueError("Unsupported GENIE genie_model type")
            return ModelSpec("genie", genie_model, tuple(comps), num_env,
                             include_nxe)
        raise ValueError(f"Unsupported model {model}")


@dataclass
class RunConfig:
    num_random_vec: int = 10
    num_jack: int = 100
    seed: int = 0
    geno_impute_method: str = "binary"
    dtype: str = "float32"          # float32 | float64 (CPU) | bfloat16
    streaming: bool = False
    get_trace: bool = False
    trace_dir: str | None = None
    device: str = "auto"            # auto | cpu | gpu
    mm_mode: str = "auto"           # auto | exact | split2 | bf16
    packed_scan: object = "auto"    # auto | True | False — chunked
                                    # lax.scan over host-cleaned packed
                                    # bytes (auto: on for accelerators)
    checkpoint_dir: str | None = None   # crash-safe resume snapshots
                                        # (core/checkpoint.py); None = off
    checkpoint_every: int = 1       # snapshot cadence, in blocks/chunks
    stage_streams: int = 1          # host->device chunk transfers in
                                    # flight; 1 = one chunk staged ahead
                                    # of the device (see _stage_depth)
    cache_blocks: int = -1          # stats-cache size override, in
                                    # jackknife blocks (per device on the
                                    # sharded path): -1 = auto (fit the
                                    # HBM budget, hybrid when short), 0 =
                                    # cache nothing (recompute pass 2),
                                    # J = cache all. Ignored when
                                    # streaming=True.
    host_cache_gb: float = -1.0     # host-RAM cache of cleaned packed
                                    # blocks so the streaming pass 2
                                    # restages from memory instead of
                                    # re-reading the .bed; -1 = auto
                                    # (enable when it fits half of
                                    # MemAvailable), 0 = off, >0 = budget


def _mem_available_bytes() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return float(line.split()[1]) * 1024
    except OSError:
        pass
    return 0.0


_DTYPES = {"float32": jnp.float32, "float64": jnp.float64,
           "bfloat16": jnp.float32}


class Engine:
    def __init__(self, data: DataBundle, spec: ModelSpec, cfg: RunConfig,
                 log: Logger | None = None):
        from ..utils.jaxcache import enable_persistent_compilation_cache
        enable_persistent_compilation_cache()
        self.data = data
        self.spec = spec
        self.cfg = cfg
        self.log = log or Logger(debug_mode=False)

        self.K = data.num_bin
        self.B = cfg.num_random_vec
        self.J = cfg.num_jack
        self.E_geno = len(spec.components) * self.K
        self.num_nxe = data.num_env if spec.include_nxe else 0
        self.E = self.E_geno + self.num_nxe
        self.T_traits = data.num_traits
        self.use_cov = data.cov is not None
        self.b2 = self.B * (2 if self.use_cov else 1)
        self.dtype = _DTYPES[cfg.dtype]
        self.mm_mode = (cfg.mm_mode if cfg.mm_mode != "auto" else
                {"float64": "exact", "float32": "split2",
                 "bfloat16": "bf16"}[cfg.dtype])

        from ..utils.types import GenoImputeMethod
        GenoImputeMethod(cfg.geno_impute_method)  # raises on unknown value

        self._dev = self._pick_device(cfg.device)
        self._setup_layout()
        # Cache sizing: the non-streaming cache holds J blocks of
        # (E_geno, N, b2) stats on device. When the full cache would not
        # fit in HBM, cache as many leading blocks as the budget allows
        # and recompute only the remainder in pass 2 (HYBRID — the
        # continuous version of the reference's all-or-nothing two-pass
        # trade-off, base_streaming.py:85-144); fall back to full
        # streaming only when not even a margin's worth of blocks fits.
        dsize = 8 if self.dtype == jnp.float64 else 4
        # N_work (set by _setup_layout above), not num_indv: cached stats
        # arrays are (E_geno, N_work, b2) with N_work the full .bed
        # population on the packed path — sizing by the kept N would
        # overestimate how many blocks fit and erode the 4-block
        # working-set reserve
        per_block = self.E_geno * (self.N_work * dsize) * self.b2
        cache_bytes = cfg.num_jack * per_block
        self.cache_limit = cfg.num_jack   # blocks pass 1 may cache
        if not cfg.streaming and cfg.cache_blocks >= 0:
            # explicit operator/test override of the hybrid split
            self.cache_limit = int(cfg.cache_blocks)
            if self.cache_limit < cfg.num_jack:
                self.log._log(
                    f"Note: stats cache capped at {self.cache_limit}/"
                    f"{cfg.num_jack} blocks (--cache_blocks); the rest is "
                    "recomputed in pass 2 (hybrid)")
        elif (not cfg.streaming and self._dev.platform != "cpu"
                and cache_bytes > self._hbm_budget()):
            # blocks of stats the budget can hold alongside totals and
            # working buffers (~4 block-equivalents: totals + staged
            # chunks + scan workspace)
            fit = int(self._hbm_budget() // per_block) - 4
            if self.packed_scan and fit >= max(1, self._chunk_size()):
                self.cache_limit = fit
                self.log._log(
                    f"Note: per-block stats cache (~{cache_bytes / 1e9:.1f}"
                    " GB) exceeds the device memory budget; caching "
                    f"{fit}/{cfg.num_jack} blocks in HBM and recomputing "
                    "the rest in pass 2 (hybrid)")
            else:
                self.log._log(
                    f"Note: per-block stats cache (~{cache_bytes / 1e9:.1f}"
                    " GB) exceeds the device memory budget; using"
                    " streaming (two-pass) mode")
                self.cfg = cfg = RunConfig(
                    **{**cfg.__dict__, "streaming": True})
        self._ckpt = None
        if cfg.checkpoint_dir:
            from .checkpoint import Checkpoint, CheckpointBusy
            nproc = jax.process_count()
            lock = (".lock" if nproc == 1
                    else f".lock.p{jax.process_index()}")
            try:
                self._ckpt = Checkpoint(cfg.checkpoint_dir,
                                        self._fingerprint(), self.log,
                                        lock_name=lock)
            except CheckpointBusy as e:
                # sharing a live run's directory would interleave commits
                # and could reset its state; run un-checkpointed instead
                self.log._log(f"WARNING: {e}; this run will NOT checkpoint")
        self._build_static_arrays()
        self._packed_cache = self._init_host_cache()
        self._cache: dict[int, tuple] = {}
        self._chunk_cache: list = []
        self._scan_fns: dict[bool, object] = {}
        self._tot = None
        self.M_mat = self._build_M_matrix()
        self.trace_sums = None
        # Cumulative per-phase wall time (seconds): precompute_s,
        # assemble_s and solve_s cover the passes end to end; host_read_s
        # and stage_s run on the staging threads overlapped with device
        # compute, so they don't sum to the pass wall time — their ratio
        # to it shows what the pass is bound by. stage_bytes and
        # host_cache_hits are counts, not seconds.
        self.phase_times: dict[str, float] = {}

    def _phase_add(self, name: str, dt: float):
        self.phase_times[name] = self.phase_times.get(name, 0.0) + dt

    def _fingerprint(self) -> dict:
        """Everything that shapes the checkpointed numerics: dataset
        identity/shapes, estimation hyperparameters, dtype/kernel modes.
        A stored checkpoint whose fingerprint differs is discarded."""
        bed = self.data.bed
        path = getattr(bed, "path", None)
        try:
            size = os.path.getsize(path) if path else None
            mtime = int(os.path.getmtime(path)) if path else None
        except OSError:
            size = mtime = None
        return {
            # size alone is a pure function of (num_snp, num_indv): a
            # regenerated/refiltered .bed with the same shapes at the same
            # path must NOT silently resume from stale totals. mtime plus
            # a sampled content hash (first/middle/last 1 MB) pins identity
            # without reading tens of GB.
            "bed": [str(path), size, mtime, self._bed_sample_sha(path)],
            "num_snp": int(self.data.num_snp),
            "num_indv": int(self.data.num_indv),
            "J": self.J, "B": self.B, "K": self.K,
            "E_geno": self.E_geno, "num_nxe": self.num_nxe,
            "b2": self.b2, "T_traits": self.T_traits,
            "seed": self.cfg.seed, "dtype": self.cfg.dtype,
            "mm_mode": self.mm_mode,
            "model": self.spec.model, "genie_model": self.spec.genie_model,
            "streaming": self.cfg.streaming,
            "impute": self.cfg.geno_impute_method,
            "packed_scan": bool(self.packed_scan),
            "N_work": int(self.N_work),
            # content hash: the probe matrix embeds the residualized
            # phenotype, and the annot drives bin masking — a run whose
            # pheno/cov/env/annot changed (same shapes) must NOT resume
            "aux_sha": self._aux_sha(),
        }

    @staticmethod
    def _bed_sample_sha(path) -> str | None:
        """Cheap content fingerprint of the .bed: sha256 over 1 MB samples
        at the start, middle, and end of the file."""
        if not path:
            return None
        import hashlib
        h = hashlib.sha256()
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                # sorted+deduped: the digest must not depend on set
                # iteration order across Python implementations
                for off in sorted({0, max(0, size // 2 - 2**19),
                                   max(0, size - 2**20)}):
                    f.seek(off)
                    h.update(f.read(2**20))
        except OSError:
            return None
        return h.hexdigest()[:16]

    def _aux_sha(self) -> str:
        import hashlib
        h = hashlib.sha256()
        for arr in (self.data.pheno, self.data.cov, self.data.env,
                    self.data.annot):
            if arr is not None:
                a = np.ascontiguousarray(np.asarray(arr, np.float64))
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
        return h.hexdigest()[:16]

    # ------------------------------------------------------------------ setup
    def _hbm_budget(self) -> float:
        """Bytes the per-block stats cache may occupy: half the device
        memory the runtime reports (the other half holds totals, staged
        chunks and working buffers). An accelerator that reports no
        memory is an error: the cache split must not rest on a guess."""
        stats = self._dev.memory_stats() or {}
        limit = stats.get("bytes_limit") or stats.get(
            "bytes_reservable_limit")
        if not limit:
            raise RuntimeError(
                f"device {self._dev} reports no memory limit "
                "(memory_stats); cannot size the stats cache")
        return 0.5 * float(limit)

    def _pick_device(self, device: str):
        # local_devices: under multi-process (jax.distributed) execution
        # this process may only device_put to its own addressable devices
        if device == "auto":
            return jax.local_devices()[0]
        for d in jax.local_devices():
            if d.platform.startswith(device):
                return d
        raise RuntimeError(
            f"device {device!r} requested but JAX found only "
            f"{sorted({d.platform for d in jax.local_devices()})}")

    def _setup_layout(self):
        """Resolve whether blocks go through the chunked packed-byte scan
        (the accelerator path).

        On that path the host rewrites missing codes with the integral
        imputation fills (io/bed.clean_packed) and stages the cleaned
        packed bytes; the device decodes them (ops/decode.py). Individual
        filtering (missing pheno/cov, data.py keep_idx) runs on this path
        too: the FULL .bed population is decoded and dropped individuals
        are zero-weighted — valid_mask zeroes them in the stage-1
        ones-column (so means and variances cover kept individuals only,
        n_indiv being the kept count) and in the stage-2 output rows,
        while _scatter_kept places every N-indexed array (probes, pheno,
        cov, env) at its ORIGINAL .bed row with zero rows at dropped
        positions. This matches the reference running its device path on
        the filtered matrix (base.py:118-135, mat_mul.py:17-31) without a
        host-side repack of the genotypes."""
        if self.cfg.packed_scan == "auto":
            self.packed_scan = self._dev.platform != "cpu"
        else:
            self.packed_scan = bool(self.cfg.packed_scan)
        self.N_work = (self.data.bed.num_indiv if self.packed_scan
                       else self.data.num_indv)

    def _scatter_kept(self, x: np.ndarray) -> np.ndarray:
        """Place an (N_kept, k) array at the individuals' ORIGINAL .bed
        rows of an (N_work, k) array, zero rows at dropped positions.
        Identity off the packed path and for unfiltered data."""
        ki = self.data.bed.keep_idx
        if not self.packed_scan or ki is None:
            return x
        out = np.zeros((self.N_work,) + x.shape[1:], x.dtype)
        out[ki] = x
        return out

    def _build_static_arrays(self):
        d = self.data
        put = lambda x: jax.device_put(
            jnp.asarray(self._scatter_kept(np.asarray(x, np.float64)),
                        dtype=self.dtype), self._dev)
        self.Y_resid = d.resid_pheno() if d.pheno is not None else np.zeros(
            (d.num_indv, 0))
        cols = [d.Z]
        if self.use_cov:
            cols.append(d.Uzb)
        if self.T_traits:
            cols.append(self.Y_resid)
        self.P = put(np.concatenate(cols, axis=1))
        self.Zd = put(d.Z)
        self.Uzbd = put(d.Uzb) if self.use_cov else jnp.zeros_like(self.Zd)
        self.Cd = put(d.cov) if self.use_cov else None
        self.Qd = jax.device_put(jnp.asarray(d.Q, self.dtype),
                                 self._dev) if self.use_cov else None
        self.envd = put(d.env) if d.num_env else None
        # 1.0 exactly at KEPT individuals' .bed positions: zeroes any
        # filtered (missing pheno/cov) individual out of every reduction
        # (stage-1 ones-column and stage-2 output rows,
        # ops/moments._moment_algebra)
        keep = np.ones(self.N_work)
        if self.packed_scan and d.bed.keep_idx is not None:
            keep[:] = 0.0
            keep[d.bed.keep_idx] = 1.0
        self.valid_mask = jax.device_put(jnp.asarray(keep, self.dtype),
                                         self._dev)
        self.q_last = jax.device_put(
            jnp.asarray((self.Y_resid ** 2).sum(axis=0), self.dtype),
            self._dev)
        self.stoch_mask = jnp.asarray(self._stochastic_mask())
        if self.num_nxe:
            Yd = put(self.Y_resid)
            self.nxe_XXP, self.nxe_yXXy = nxe_stats(
                self.envd, self.Zd, self.Uzbd, Yd, self.b2, self.B,
                self.dtype)

    def _stochastic_mask(self) -> np.ndarray:
        """Border-trace rows estimated stochastically: GENIE rows k >= num_bin
        (reference genie.py:84-94); exact tr K = N elsewhere."""
        mask = np.zeros(self.E, dtype=bool)
        if self.spec.model == "genie":
            mask[self.K:] = True
        return mask

    def _init_host_cache(self):
        """Host-RAM cache of cleaned packed blocks for streaming pass 2.

        Streaming trades memory for a second full genotype pass; the
        reference re-reads every block from disk
        (base_streaming.py:116-118). On attached hardware the host
        read+clean is a large share of the restage cost, so when the
        packed bytes fit in host RAM, pass 2 serves them from memory —
        bit-identical (the per-block imputation fills are deterministic,
        _fill_from_stats) and transparent to checkpoint/resume.
        cfg.host_cache_gb: -1 auto (fit within half of MemAvailable),
        0 off, >0 explicit budget in GB."""
        if not self.cfg.streaming or self.cfg.host_cache_gb == 0:
            return None
        est = self._host_cache_estimate()
        budget = (self.cfg.host_cache_gb * 1e9
                  if self.cfg.host_cache_gb > 0
                  else _mem_available_bytes() * 0.5)
        if est > budget:
            self.log._debug(
                f"host packed-block cache off: needs ~{est / 1e9:.1f} GB, "
                f"budget {budget / 1e9:.1f} GB")
            return None
        self.log._debug(
            f"host packed-block cache on (~{est / 1e9:.2f} GB): streaming "
            "pass 2 will restage without re-reading the .bed")
        return {}

    def _host_cache_estimate(self) -> float:
        """Upper bound on cached bytes for the active block format."""
        d = self.data
        if self.packed_scan or (d.bed.keep_idx is None and
                                self.cfg.geno_impute_method == "mean"):
            return float(d.num_snp * d.bed.bytes_per_snp)
        return float(d.num_snp * d.num_indv)   # decoded uint8 "host" mode

    def _block_range(self, j: int):
        """Contiguous SNP blocks; last absorbs remainder (reference base.py:362-379)."""
        step = self.data.num_snp // self.J
        start = j * step
        end = start + step if j < self.J - 1 else self.data.num_snp
        return start, end

    def _m_last_row(self) -> np.ndarray:
        lb = self.data.len_bin
        rows = [lb for _ in self.spec.components]
        out = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
        if self.num_nxe:
            out = np.concatenate([out, np.ones(self.num_nxe, dtype=np.int64)])
        return out.astype(np.int64)

    def _build_M_matrix(self) -> np.ndarray:
        """M (J+1, E): leave-one-out SNP counts per estimate; last row =
        full-genome counts (reference base.py:450, rhe.py:16, genie.py:79-82)."""
        M = np.zeros((self.J + 1, self.E), dtype=np.int64)
        last = self._m_last_row()
        M[self.J] = last
        for j in range(self.J):
            s, e = self._block_range(j)
            m_blk = self.data.annot[s:e].sum(axis=0)
            row = np.concatenate([m_blk] * len(self.spec.components))
            if self.num_nxe:
                row = np.concatenate(
                    [last[:self.E_geno] - row, np.ones(self.num_nxe,
                                                       dtype=np.int64)])
            else:
                row = last - row
            M[j] = row
        return M

    # ------------------------------------------------------------- block pass
    def _fill_from_stats(self, sums, nmiss, n_total, m_block):
        """Per-SNP HWE imputation draws, reproducing the reference's RNG
        discipline exactly: reseed per block, one uniform draw per SNP
        whether or not it has missing entries (base.py:265-289,510)."""
        n_obs = n_total - nmiss
        p = np.divide(sums, n_obs, out=np.zeros_like(sums),
                      where=n_obs > 0) * 0.5
        rs = np.random.RandomState(self.cfg.seed)
        rval = rs.random_sample(m_block)
        d0 = (1 - p) ** 2
        d1 = 2 * p * (1 - p)
        return np.where(rval < d0, 0.0,
                        np.where(rval < d0 + d1, 1.0, 2.0))

    def _load_block(self, j: int, raw: bool = False):
        """Host-side block fetch -> (geno array, fill, mode), memoized in
        the host-RAM packed cache when enabled (streaming pass 2 then
        restages from memory instead of re-reading + re-cleaning the
        .bed — the reference's streaming mode re-reads from disk,
        base_streaming.py:116-118)."""
        if not raw and self._packed_cache is not None:
            hit = self._packed_cache.get(j)
            if hit is not None:
                self._phase_add("host_cache_hits", 1.0)
                return hit
        out = self._load_block_uncached(j, raw)
        if not raw and self._packed_cache is not None:
            self._packed_cache[j] = out
        return out

    def _load_block_uncached(self, j: int, raw: bool = False):
        """Host-side block fetch -> (geno array, fill, mode).

        mode: "clean" (packed bytes with the missing codes rewritten to
        the fills — the packed-scan path), "packed" (packed bytes for
        on-device decode + impute), or "host" (decoded uint8 dosages).
        raw=True forces a non-scan path."""
        s, e = self._block_range(j)
        m = e - s
        bed = self.data.bed
        if not raw and self.packed_scan:
            packed = bed.read_packed_block(s, e)
            if self.cfg.geno_impute_method == "binary":
                sums, nmiss = bed.packed_col_stats(packed)
                fill = self._fill_from_stats(sums, nmiss,
                                             self.data.num_indv, m)
            else:
                fill = np.zeros(m)
            from ..io.bed import clean_packed
            # Imputation fills are integral (HWE draw / mean-mode 0), so the
            # missing codes are rewritten into the packed bytes HERE (C++
            # byte LUT) and the device decode finds no missing code.
            return clean_packed(packed, fill), fill, "clean"
        use_packed = (bed.keep_idx is None
                      and self.cfg.geno_impute_method == "mean")
        if use_packed:
            return bed.read_packed_block(s, e), np.zeros(m), "packed"
        geno = bed.read_block(s, e)
        if self.cfg.geno_impute_method == "binary":
            sums, nmiss = bed.col_stats(geno)
            fill = self._fill_from_stats(sums, nmiss, geno.shape[1], m)
        else:
            fill = np.zeros(m)
        return geno, fill, "host"

    def _compute_block(self, j: int):
        geno, fill, mode = self._load_block(j)
        return self._block_stats_device(j, geno, fill, mode)

    def _block_stats_device(self, j: int, geno, fill, mode):
        s, e = self._block_range(j)
        np_dt = np.float32 if self.dtype != jnp.float64 else np.float64
        annot_f = self.data.annot[s:e].astype(np_dt)
        if mode == "clean":
            return self._clean_stats(
                jax.device_put(geno, self._dev),
                jax.device_put(jnp.asarray(annot_f, self.dtype), self._dev))
        return block_stats(
            jax.device_put(geno, self._dev),
            jax.device_put(jnp.asarray(fill, self.dtype), self._dev),
            jax.device_put(jnp.asarray(annot_f, self.dtype), self._dev),
            self.P,
            self.envd,
            n_indiv=self.data.num_indv,
            components=self.spec.components,
            b2=self.b2,
            packed=(mode == "packed"),
            dtype=self.dtype,
            mm_mode=self.mm_mode,
        )

    def _prefetched_blocks(self, indices):
        """Yield (j, device stats) with host .bed reads + fills running one
        block ahead on a background thread, overlapping disk/decode with
        device compute (the role of the reference's worker pool +
        streaming overlap, base_streaming.py:85-104)."""
        from concurrent.futures import ThreadPoolExecutor

        indices = list(indices)
        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(self._load_block, indices[0])
            for pos, j in enumerate(indices):
                geno, fill, packed = nxt.result()
                if pos + 1 < len(indices):
                    nxt = ex.submit(self._load_block, indices[pos + 1])
                yield j, self._block_stats_device(j, geno, fill, packed)

    def precompute(self):
        """Pass 1: accumulate totals (and cache block stats unless streaming).

        Word path: blocks go to the device in CHUNKS and each chunk is one
        jitted lax.scan dispatch (host reads + byte-clean staged one chunk
        ahead), so per-block dispatch and transfer latency stay off the
        device's critical path."""
        t0 = time.time()
        if self.packed_scan and self.J > 1:
            self._precompute_chunked()
        else:
            self._precompute_blocks()
        jax.block_until_ready(self._tot)
        self._phase_add("precompute_s", time.time() - t0)
        self.log._debug(f"Precompute total time: {time.time() - t0}")

    def _ckpt_precompute_state(self, chunked: bool):
        """Resume bookkeeping for pass 1. Returns (start_j, host totals or
        None). start_j == J means pass 1 is already complete: totals are
        installed and (non-streaming) the stats cache is reloaded.

        start_j comes from totals.npz itself, NOT meta: a crash between
        the totals save and the meta commit leaves the file one interval
        ahead, and its own next_j is what its content covers."""
        if self._ckpt is None:
            return 0, None
        st = self._ckpt.state()
        if st is None:
            return 0, None
        ld = self._ckpt.load_totals()
        if ld is None:
            return 0, None
        tot = (ld[0], ld[1])
        phase, _ = st
        start_j = self.J if phase in ("assemble", "done") else ld[2]
        if start_j <= 0:
            return 0, None
        self.log._log(
            f"Resuming precompute from checkpoint: {start_j}/{self.J} "
            f"jackknife blocks already covered ({self.cfg.checkpoint_dir})")
        if not self.cfg.streaming:
            if chunked:
                # tolerant prefix load: under the hybrid cache only the
                # HBM-budgeted chunks have files; anything not on disk is
                # recomputed by the pass-2 walk (_assemble_chunked), so a
                # partial prefix degrades throughput, never correctness
                chunks = self._ckpt.load_chunks_prefix(start_j)
                self._chunk_cache = [
                    (j0, C, jax.device_put(jnp.asarray(Xs, self.dtype),
                                           self._dev),
                     jax.device_put(jnp.asarray(Ys, self.dtype), self._dev))
                    for j0, C, Xs, Ys in chunks]
            else:
                # tolerant: under a cache_limit only the budgeted blocks
                # have files; holes are recomputed by _loo_stats' cache
                # miss branch, so a partial load degrades throughput only
                self._cache = self._ckpt.load_blocks_partial(start_j)
        return start_j, tot

    def _put_tot(self, tot):
        return tuple(jax.device_put(jnp.asarray(a, self.dtype), self._dev)
                     for a in tot)

    def _precompute_blocks(self):
        """Per-block pass 1 (local backends, where dispatch is cheap)."""
        start_j, tot = self._ckpt_precompute_state(chunked=False)
        if tot is not None:
            tot_XXP, tot_y = self._put_tot(tot)
        else:
            tot_XXP = jnp.zeros((self.E_geno, self.N_work, self.b2),
                                self.dtype)
            tot_y = jnp.zeros((self.E_geno, max(self.T_traits, 0)),
                              self.dtype)
        self._tot = (tot_XXP, tot_y)
        if start_j >= self.J:
            return
        every = max(1, self.cfg.checkpoint_every)
        for j, (XXP, yXXy, _) in self._prefetched_blocks(
                range(start_j, self.J)):
            tot_XXP = tot_XXP + XXP
            tot_y = tot_y + yXXy
            # cache_limit also gates this non-chunked path: beyond the
            # budget pass 2 recomputes via _loo_stats' cache-miss branch
            if not self.cfg.streaming and len(self._cache) < self.cache_limit:
                self._cache[j] = (XXP, yXXy)
                if self._ckpt:
                    self._ckpt.stage_block(j, XXP, yXXy)
            if self._ckpt and (j + 1 - start_j) % every == 0:
                self._ckpt.save_totals(tot_XXP, tot_y, j + 1)
                self._ckpt.commit("precompute", j + 1)
            self.log._debug(f"jackknife {j} precompute done")
        self._tot = (tot_XXP, tot_y)
        if self._ckpt:
            self._ckpt.save_totals(tot_XXP, tot_y, self.J)
            self._ckpt.commit("assemble", 0)

    def _scan_stats_fn(self):
        """stats(clean packed block, annot, P, env, mask) of the packed
        path — ONE definition for the sequential engine and the sharded
        runner. The fills already sit in the cleaned bytes, so the decode
        meets no missing code and the zero fill is never used."""
        kw = dict(n_indiv=self.data.num_indv,
                  components=self.spec.components, b2=self.b2, packed=True,
                  dtype=self.dtype, mm_mode=self.mm_mode)

        def stats(geno, annot, P, env, mask):
            fill = jnp.zeros(geno.shape[0], self.dtype)
            return block_stats_core(geno, fill, annot, P, env,
                                    valid_mask=mask, **kw)
        return stats

    def _clean_stats(self, geno, annot):
        fn = self._scan_fns.get("block")
        if fn is None:
            fn = self._scan_fns["block"] = jax.jit(self._scan_stats_fn())
        return fn(geno, annot, self.P, self.envd, self.valid_mask)

    def _chunk_scan_fn(self, keep_blocks: bool):
        """Jitted: scan block stats over a stacked chunk of equal-size
        blocks, accumulating totals in the scan carry (one dispatch per
        chunk instead of one per block) and stacking per-block stats when
        keep_blocks (non-streaming). Memoized on keep_blocks so the
        streaming assemble pass reuses the precompute pass's jit closure
        (and its compilation cache entries). The totals are donated, so
        the carry updates in place."""
        cached = self._scan_fns.get(keep_blocks)
        if cached is not None:
            return cached
        stats = self._scan_stats_fn()

        def run(geno_s, annot_s, tot_X, tot_y, P, env, mask):
            def body(carry, xs):
                g, a = xs
                XXP, yXXy, _ = stats(g, a, P, env, mask)
                out = (XXP, yXXy) if keep_blocks else None
                return (carry[0] + XXP, carry[1] + yXXy), out

            return jax.lax.scan(body, (tot_X, tot_y), (geno_s, annot_s))

        run = jax.jit(run, donate_argnums=(2, 3))
        self._scan_fns[keep_blocks] = run
        return run

    def _iter_chunks(self, chunk: int, start_j: int = 0,
                     stop_j: int | None = None):
        """Yield (j0, [(clean packed (m, bytes_per_snp), annot (m, K))...])
        stacked host chunks for blocks [start_j, stop_j); the uneven last
        block (larger m_pad) comes out as its own chunk of 1. start_j must
        be a chunk boundary from a previous identical iteration
        (checkpoints only commit at chunk boundaries), so resumed chunk
        boundaries reproduce exactly."""
        np_dt = np.float32 if self.dtype != jnp.float64 else np.float64
        buf, j0 = [], start_j
        for j in range(start_j, self.J if stop_j is None else stop_j):
            t0 = time.perf_counter()
            geno, fill, mode = self._load_block(j)
            self._phase_add("host_read_s", time.perf_counter() - t0)
            assert mode == "clean"
            s, e = self._block_range(j)
            annot = self.data.annot[s:e].astype(np_dt)
            if buf and buf[0][0].shape != geno.shape:
                yield j0, buf
                j0, buf = j, []
            buf.append((geno, annot))
            if len(buf) == chunk:
                yield j0, buf
                j0, buf = j + 1, []
        if buf:
            yield j0, buf

    def _chunk_size(self) -> int:
        blk_bytes = self.data.bed.bytes_per_snp * (
            self.data.num_snp // self.J)
        return int(min(self.J, max(1, 256e6 // max(blk_bytes, 1))))

    def _stage_depth(self) -> int:
        """Chunk transfers in flight. One chunk staged ahead of the
        device (the default) keeps a local PCIe link busy while the
        device scans the current chunk; more streams only add pinned
        host memory."""
        return max(1, self.cfg.stage_streams)

    def _env_arg(self):
        return (self.envd if self.data.num_env else
                jnp.zeros((self.N_work, 1), self.dtype))

    def _chunked_stats_stream(self, keep, start_j: int = 0,
                              init_tot=None, stop_j: int | None = None):
        """Yield (j0, n_real, Xs, Ys, tot_X, tot_y) per chunk with host
        read+clean+stack prefetched one chunk ahead and totals carried on
        device (Xs/Ys are None for unkept chunks). The LAST yielded totals
        are the grand totals over [start_j, stop_j). start_j/init_tot
        resume a checkpointed pass from a chunk boundary with restored
        accumulators.

        `keep` is True/False (keep all/none) or an int: the number of
        blocks from start_j whose stats may be kept — the HYBRID budget.
        A chunk is kept only if it fits entirely under the remaining
        budget (mostly a prefix; a smaller trailing chunk may still
        slip under it — consumers index kept chunks by j0, not by
        contiguity)."""
        from concurrent.futures import ThreadPoolExecutor

        keep_limit = (self.J if keep is True
                      else 0 if keep is False else int(keep))
        kept = 0
        env_arg = self._env_arg()

        def stage(item):
            j0, buf = item
            t0 = time.perf_counter()
            out = (j0, len(buf),
                   jax.device_put(np.stack([b[0] for b in buf]), self._dev),
                   jax.device_put(np.stack([b[1] for b in buf]), self._dev))
            jax.block_until_ready(out[2:])   # count transfer, not enqueue
            # stage_s sums per-chunk transfer time across the (possibly
            # concurrent) staging threads — thread-seconds, not wall time;
            # stage_bytes / wall clock gives the effective staging rate
            self._phase_add("stage_s", time.perf_counter() - t0)
            self._phase_add("stage_bytes",
                            float(sum(b[0].nbytes + b[1].nbytes
                                      for b in buf)))
            return out

        if init_tot is not None:
            tot_X, tot_y = self._put_tot(init_tot)
        else:
            tot_X = jnp.zeros((self.E_geno, self.N_work, self.b2),
                              self.dtype)
            tot_y = jnp.zeros((self.E_geno, max(self.T_traits, 0)),
                              self.dtype)
        it = self._iter_chunks(self._chunk_size(), start_j, stop_j)
        depth = self._stage_depth()
        from collections import deque
        with ThreadPoolExecutor(max_workers=depth) as ex:
            pending: deque = deque()

            def refill():
                # keep `depth` chunk transfers in flight; host reads
                # (next(it)) stay on this thread, the device_put streams
                # run concurrently on the pool
                while len(pending) < depth:
                    try:
                        pending.append(ex.submit(stage, next(it)))
                    except StopIteration:
                        return

            refill()
            while pending:
                j0, C, geno_s, annot_s = pending.popleft().result()
                refill()
                keep_c = kept + C <= keep_limit
                kept += C if keep_c else 0
                run = self._chunk_scan_fn(keep_c)
                t0 = time.perf_counter()
                (tot_X, tot_y), ys = run(geno_s, annot_s, tot_X, tot_y,
                                         self.P, env_arg, self.valid_mask)
                self._phase_add("scan_dispatch_s", time.perf_counter() - t0)
                self.log._debug(f"chunk at block {j0} (+{C}) done")
                yield (j0, C, ys[0] if keep_c else None,
                       ys[1] if keep_c else None, tot_X, tot_y)

    def _precompute_chunked(self):
        self._chunk_cache = []
        start_j, tot = self._ckpt_precompute_state(chunked=True)
        # int budget: J = full cache, 0 = streaming, else hybrid — the
        # stream keeps whole chunks while they fit and yields Xs=None
        # beyond the budget. Chunks restored from a checkpoint count
        # against the budget.
        keep = (0 if self.cfg.streaming else
                max(0, self.cache_limit
                    - sum(C for _, C, _, _ in self._chunk_cache)))
        if tot is not None:
            self._tot = self._put_tot(tot)
        if start_j >= self.J:
            return
        every = max(1, self.cfg.checkpoint_every)
        n_chunks = 0
        for j0, C, Xs, Ys, tot_X, tot_y in self._chunked_stats_stream(
                keep, start_j=start_j, init_tot=tot):
            if Xs is not None:
                self._chunk_cache.append((j0, C, Xs, Ys))
                if self._ckpt:
                    self._ckpt.stage_chunk(j0, C, Xs, Ys)
            self._tot = (tot_X, tot_y)
            n_chunks += 1
            if self._ckpt and n_chunks % every == 0:
                self._ckpt.save_totals(tot_X, tot_y, j0 + C)
                self._ckpt.commit("precompute", j0 + C)
        if self._ckpt:
            self._ckpt.save_totals(*self._tot, self.J)
            self._ckpt.commit("assemble", 0)

    # --------------------------------------------------------------- assembly
    def _loo_stats(self, j: int, block=None):
        """Leave-one-out (or total, j == J) stats with NxE rows appended."""
        tot_XXP, tot_y = self._tot
        if j == self.J:
            XXP, yXXy = tot_XXP, tot_y
        else:
            blk = block if block is not None else self._cache.get(j)
            if blk is None:
                bXXP, byXXy, _ = self._compute_block(j)
            else:
                bXXP, byXXy = blk[0], blk[1]
            XXP, yXXy = tot_XXP - bXXP, tot_y - byXXy
        if self.num_nxe:
            XXP = jnp.concatenate([XXP, self.nxe_XXP], axis=0)
            yXXy = jnp.concatenate([yXXy, self.nxe_yXXy], axis=0)
        return XXP, yXXy

    def assemble(self):
        """Pass 2: build T_all (J+1, E+1, E+1) and q_all (J+1, E+1, T) f64.
        Streaming mode re-computes block stats (prefetched) instead of
        reading the cache.

        Word path: one assemble_Tq_chunk dispatch per precompute chunk
        (stats chunks consumed as-is — no per-block slicing, restacking or
        per-sample dispatch). The full-data sample is a final 1-sample
        chunk with a zero block."""
        t0 = time.time()
        if self.packed_scan and self.J > 1:
            self._assemble_chunked()
        else:
            self._assemble_per_sample()
        self._phase_add("assemble_s", time.time() - t0)
        self.log._debug(f"Assemble total time: {time.time() - t0}")
        if self._ckpt:
            self._ckpt.save_results(self.T_all, self.q_all)
            self._ckpt.commit("done", self.J)
        if self.cfg.get_trace:
            self.trace_sums = self._compute_trace_sums()
        return self.T_all, self.q_all

    def _ckpt_assemble_state(self, Ts: list, qs: list) -> int:
        """Resume bookkeeping for the streaming pass 2: loads the partial
        (T, q) samples into Ts/qs and returns the first block to
        recompute."""
        if self._ckpt is None:
            return 0
        st = self._ckpt.state()
        if st is None or st[0] not in ("assemble", "done"):
            return 0
        ld = self._ckpt.load_assemble()
        if ld is None:
            return 0
        T_part, q_part, next_j = ld
        Ts.append(jnp.asarray(T_part, self.dtype))
        qs.append(jnp.asarray(q_part, self.dtype))
        self.log._log(
            f"Resuming assemble from checkpoint: {next_j}/{self.J} "
            "jackknife samples already built")
        return next_j

    def _assemble_args(self):
        tot_XXP, tot_y = self._tot
        nxe_XXP = (self.nxe_XXP if self.num_nxe else
                   jnp.zeros((0,) + tot_XXP.shape[1:], self.dtype))
        nxe_y = (self.nxe_yXXy if self.num_nxe else
                 jnp.zeros((0,) + tot_y.shape[1:], self.dtype))
        kw = dict(num_random_vec=self.B, n_indiv=self.data.num_indv,
                  n_cov=self.data.cov.shape[1] if self.use_cov else 0)
        return tot_XXP, tot_y, nxe_XXP, nxe_y, kw

    def _assemble_chunked(self):
        """One assemble_Tq_chunk dispatch per precompute chunk. The cached
        chunks are consumed (popped) as they are assembled so peak HBM
        stays at one cache copy plus working buffers — never a second
        concatenated copy of the whole stats cache."""
        from .normal_eq import assemble_Tq_chunk

        tot_XXP, tot_y, nxe_XXP, nxe_y, kw = self._assemble_args()
        Ts, qs = [], []
        start_j = self._ckpt_assemble_state(Ts, qs)
        every = max(1, self.cfg.checkpoint_every)
        n_chunks = 0

        def asm(j0, C, Xs, Ys):
            """Assemble one chunk and run the shared checkpoint cadence —
            both branches (cached pops, hybrid gap recompute, streaming)
            save partial (T, q) so a crash never loses the whole pass."""
            nonlocal n_chunks
            T, q = assemble_Tq_chunk(
                tot_XXP, tot_y, Xs, Ys,
                jnp.asarray(self.M_mat[j0:j0 + C]), nxe_XXP, nxe_y,
                self.Zd, self.Uzbd, self.Cd, self.Qd,
                self.q_last, self.stoch_mask, **kw)
            Ts.append(T)
            qs.append(q)
            n_chunks += 1
            if self._ckpt and n_chunks % every == 0:
                self._ckpt.save_assemble(jnp.concatenate(Ts),
                                         jnp.concatenate(qs), j0 + C)
                self._ckpt.commit("assemble", j0 + C)

        if not self.cfg.streaming:
            # Walk blocks in order, consuming HBM-cached chunks where they
            # exist and recomputing (restage + stats) the gaps — the HYBRID
            # middle ground between full-cache (everything cached, no gap)
            # and streaming (nothing cached, one full-range gap). Cached
            # entries are popped as assembled so peak HBM stays at one
            # cache copy. Bit-identical to both extremes: per-block stats
            # do not depend on which pass computes them. A resume drops
            # cached chunks already covered by the restored partial
            # (chunk boundaries are deterministic, so start_j is always a
            # boundary of this run's walk too).
            cached = {j0: (C, Xs, Ys) for j0, C, Xs, Ys in self._chunk_cache
                      if j0 >= start_j}
            self._chunk_cache = []
            j = start_j
            while j < self.J:
                if j in cached:
                    C, Xs, Ys = cached.pop(j)
                    asm(j, C, Xs, Ys)
                    j += C
                else:
                    stop = min(cached, default=self.J)
                    for j0, C, Xs, Ys, _, _ in self._chunked_stats_stream(
                            True, start_j=j, stop_j=stop):
                        asm(j0, C, Xs, Ys)
                    j = stop
        else:
            # streaming: one dispatch per recomputed chunk, O(chunk) memory
            for j0, C, Xs, Ys, _, _ in self._chunked_stats_stream(
                    True, start_j=start_j):
                asm(j0, C, Xs, Ys)
        # sample J = full data: a zero block (total - 0)
        T, q = assemble_Tq_chunk(
            tot_XXP, tot_y, jnp.zeros((1,) + tot_XXP.shape, self.dtype),
            jnp.zeros((1,) + tot_y.shape, self.dtype),
            jnp.asarray(self.M_mat[self.J:]), nxe_XXP, nxe_y,
            self.Zd, self.Uzbd, self.Cd, self.Qd,
            self.q_last, self.stoch_mask, **kw)
        Ts.append(T)
        qs.append(q)
        self.T_all = np.asarray(jnp.concatenate(Ts), dtype=np.float64)
        self.q_all = np.asarray(jnp.concatenate(qs), dtype=np.float64)

    def _assemble_per_sample(self):
        """Per-sample loop (local backends, where dispatch is cheap)."""
        Ts, qs = [], []
        start_j = 0
        if self.cfg.streaming and self._ckpt:
            st = self._ckpt.state()
            ld = (self._ckpt.load_assemble()
                  if st is not None and st[0] in ("assemble", "done")
                  else None)
            if ld is not None and ld[2] > 0:
                T_part, q_part, start_j = ld
                Ts.extend(jnp.asarray(T_part, self.dtype))
                qs.extend(jnp.asarray(q_part, self.dtype))
                self.log._log(
                    f"Resuming assemble from checkpoint: {start_j}/"
                    f"{self.J} jackknife samples already built")
        blocks = iter(())
        if self.cfg.streaming:
            blocks = self._prefetched_blocks(range(start_j, self.J))
        every = max(1, self.cfg.checkpoint_every)
        for j in range(start_j, self.J + 1):
            blk = None
            if self.cfg.streaming and j < self.J:
                _, blk = next(blocks)
            XXP, yXXy = self._loo_stats(j, block=blk)
            T, q = assemble_Tq(
                XXP, yXXy, jnp.asarray(self.M_mat[j]), self.Zd, self.Uzbd,
                self.Cd, self.Qd, self.q_last, self.stoch_mask,
                num_random_vec=self.B,
                n_indiv=self.data.num_indv,
                n_cov=self.data.cov.shape[1] if self.use_cov else 0,
            )
            Ts.append(T)
            qs.append(q)
            if (self.cfg.streaming and self._ckpt and j < self.J
                    and (j + 1 - start_j) % every == 0):
                self._ckpt.save_assemble(jnp.stack(Ts), jnp.stack(qs),
                                         j + 1)
                self._ckpt.commit("assemble", j + 1)
        self.T_all = np.asarray(jnp.stack(Ts), dtype=np.float64)
        self.q_all = np.asarray(jnp.stack(qs), dtype=np.float64)

    def _compute_trace_sums(self):
        """SUMRHE LD-sum matrix from assembled T (reference base.py:598-599)."""
        n = self.data.num_indv
        Mf = self.M_mat.astype(np.float64)
        MM = Mf[:, :, None] * Mf[:, None, :]
        tr = self.T_all[:, :self.E, :self.E]
        return np.where(MM != 0, S.calc_lsum(tr, n, Mf[:, :, None],
                                             Mf[:, None, :]), 0.0)

    # ------------------------------------------------------------- sharded
    def run_sharded(self, mesh=None):
        """Multi-device / multi-host execution: jackknife blocks sharded
        over the mesh 'jack' axis, per-process host IO, chunked scans over
        cleaned packed bytes on the hot path, any J (padded), streaming or
        cached pass 2 (pyrhe_tpu.parallel.sharded.ShardedRunner)."""
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedRunner

        t0 = time.time()
        mesh = mesh or make_mesh()
        runner = ShardedRunner(self, mesh)
        self.T_all, self.q_all = runner.run()
        self._phase_add("sharded_run_s", time.time() - t0)
        if self.cfg.get_trace:
            self.trace_sums = self._compute_trace_sums()
        return self.T_all, self.q_all

    # ----------------------------------------------------------- XtXz export
    def get_XtXz(self, output: str, jackknife_blocks: bool = True):
        """X^T X z sumstat export (reference base.py:890-995): per-block
        SNP-side probes Z_j, Xz = sum_j G_j Z_j over UNstandardized imputed
        dosages, then XtXz rows per block, dumped as float64 `.txt.bin`
        binaries plus per-jackknife leave-one-out versions and logged trace
        estimates ||XtXz||^2/(B*M^2).

        Implementation is two batched passes: pass A accumulates Xz_total
        and keeps per-block Xz_j; pass B computes G_i^T [Xz_total | Xz_1..]
        in one wide matmul per block instead of the reference's J^2 pair
        loop (which also reuses block j's genotype for every pair — a bug;
        this implements the intended leave-one-out semantics). Per-block
        probes are drawn from np.random.default_rng([seed, j]) (the
        reference's pool-worker draws from the global stream are order-
        nondeterministic, base.py:895).
        """
        from ..ops.moments import _mm

        B = self.B
        J = self.J
        d = self.data
        mm = lambda a, b: _mm(a, b, self.mm_mode, self.dtype)

        Zs = [np.random.default_rng([self.cfg.seed, j]).normal(
            size=(self._block_range(j)[1] - self._block_range(j)[0], B))
            for j in range(J)]

        Xz_blocks = []
        for j, geno_fill in enumerate(self._iter_raw_blocks()):
            g = geno_fill  # (m, N) imputed dosage on device
            Xz_blocks.append(mm(g.T, jnp.asarray(Zs[j], self.dtype)))
        Xz_all = jnp.stack(Xz_blocks)                 # (J, N, B)
        Xz_total = jnp.sum(Xz_all, axis=0)            # (N, B)

        results = np.zeros((d.num_snp, B))
        cross_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        cross = (np.zeros((d.num_snp, J, B), cross_dt)
                 if jackknife_blocks else None)
        wide = jnp.concatenate(
            [Xz_total[:, :, None],
             jnp.moveaxis(Xz_all, 0, 2)] if jackknife_blocks
            else [Xz_total[:, :, None]], axis=2)      # (N, B, 1+J)
        wide2 = wide.reshape(d.num_indv, -1)
        for j, g in enumerate(self._iter_raw_blocks()):
            s, e = self._block_range(j)
            out = np.asarray(mm(g, wide2)).reshape(e - s, B, -1)
            results[s:e] = out[:, :, 0]
            if jackknife_blocks:
                cross[s:e] = out[:, :, 1:].transpose(0, 2, 1)

        trace_est = np.square(results).sum() / (B * d.num_snp ** 2)
        self.log._debug(f"The trace estimate is {trace_est}")
        with open(f"{output}.txt.bin", "wb") as f:
            results.tofile(f)

        if jackknife_blocks:
            for j in range(J):
                s, e = self._block_range(j)
                loo = results - cross[:, j, :]        # G_i^T (Xz_tot - Xz_j)
                loo = np.delete(loo, np.s_[s:e], axis=0)
                m_loo = loo.shape[0]
                jk_trace = np.square(loo).sum() / (B * m_loo ** 2)
                self.log._debug(
                    f"The trace estimate of {j}-th jackknife block is "
                    f"{jk_trace}")
                with open(f"{output}.jack_{j}.txt.bin", "wb") as f:
                    loo.astype(np.float64).tofile(f)
        return results

    def _iter_raw_blocks(self):
        """Yield each block's imputed UNstandardized dosage (m, N) on device."""
        from ..ops.decode import decode_packed_jnp, dosage_from_u8, impute

        for j in range(self.J):
            geno, fill, mode = self._load_block(j, raw=True)
            geno_d = jax.device_put(geno, self._dev)
            if mode == "packed":
                g, miss = decode_packed_jnp(geno_d, self.data.num_indv,
                                            self.dtype)
            else:
                g, miss = dosage_from_u8(geno_d, self.dtype)
            yield impute(g, miss, jnp.asarray(fill, self.dtype))

    # -------------------------------------------------------------- estimate
    def run_precompute_and_assemble(self):
        if self._ckpt:
            st = self._ckpt.state()
            if st is not None and st[0] == "done":
                res = self._ckpt.load_results()
                if res is not None:
                    self.T_all, self.q_all = res
                    self.log._log(
                        "Resumed completed (T, q) from checkpoint "
                        f"({self.cfg.checkpoint_dir}); skipping both passes")
                    if self.cfg.get_trace:
                        self.trace_sums = self._compute_trace_sums()
                    return
        self.precompute()
        self.assemble()

    def estimate(self, trait: int = 0, method: str = "QR"):
        """Returns (sigma_jackknife (J, E+1), sigma_total (E+1,)).

        num_jack == 1 substitutes the full-data sample for the single
        jackknife sample (reference base.py:654-655)."""
        q = self.q_all[:, :, trait]
        T = self.T_all
        if self.J == 1:
            T = T.copy()
            q = q.copy()
            T[0], q[0] = T[1], q[1]
        t0 = time.time()
        sigma = S.solve_all(T, q, method=method)
        self._phase_add("solve_s", time.time() - t0)
        return sigma[:-1], sigma[-1]
