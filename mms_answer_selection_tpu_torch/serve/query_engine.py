"""Query engine: index a candidate pool, score queries, take the top-k, and
optionally rerank a shortlist with the full model (counterpart of
``serve/query_engine.py``).

``build_index`` embeds and packs the pool chunk by chunk into one flat
candidate-major tensor, so the float32 tokens of a 1M-candidate pool never
exist at once.  ``query`` projects the query tokens through the learned
metric and scores the pool with the MaxSim kernel of its dtype (bf16, int8
or int4), ``chunk_size`` candidates at a time, merging each chunk's top-k
into the running one, so the (Nq, C) scores never exist at once either.
``query_rerank`` shortlists with it, gathers the shortlisted candidate ids
on the device, rescores those pairs with the V4 interaction model, and
returns the top-k by P(correct).

The index lifecycle: ``build_index(reserve=)`` leaves room to grow,
``add_candidates`` packs only the new rows, ``remove_candidates``
tombstones rows (their scores fall to the mask, and ``k`` is clamped to
the live rows, so they never come back), ``compact`` drops the tombstones,
and ``save_index`` / ``load_index`` keep a built index in this package's
own ``.npz`` format.  ``build_ivf`` / ``query_ivf`` put an IVF index in
front of the exact scan (``serve/ivf.py``).

Ties: ``lax.top_k`` puts the lower index first, while ``torch.topk`` on
CUDA promises no order.  ``topk`` below fixes the reference's rule, and
the chunk merge keeps it: an earlier chunk's entries come first.

``scan_chunks`` (default True): on the card ``query`` is one CUDA graph
replay of the whole chunk scan with its running top-k merge, as the JAX
package's ``lax.scan`` is one dispatch; ``query_rerank`` is one replay of
shortlist, device gather, V4 forward and top-k; ``query_ivf`` and
``IVFIndex.query_coarse`` are one replay each over the query batch
(``utils/graphs.py``: a graph per path, shape and the ints it closes
over, captured the first time it runs).  False: the same work as eager
launches, chunk by chunk from the host, and ``query_rerank`` as two
phases.  The graphs read the pool, the ids, the weights and the IVF index
in place, so every call that rebinds or reshapes them (a build, an add, a
removal, ``compact``, ``load_index``, ``build_ivf``, new ``params``)
bumps ``version``, which drops them all.

``mesh``: the pool split along the candidate axis over every rank of a
``parallel.make_mesh`` mesh.  Rank s holds the contiguous global rows
[s * P, (s + 1) * P), P = ceil((C + reserve) / ranks), the rows past the
pool masked; each rank scores its rows with the MaxSim kernel chunk by
chunk into a local top-k, and the local top-k's values and global indices
are gathered bit for bit and merged in rank order, so ties still go to
the lower global index.  The candidate ids stay whole on every rank, so
``query_rerank`` rescores the merged shortlist on each.  Every rank holds
the same number of rows (the last ranks' tails masked), so the ranks' keys
agree whatever the pool's size.  On an NCCL mesh ``query`` and
``query_rerank`` are graph replays with that gather inside; on a gloo mesh
they run eagerly.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.mms_qa import MMSQAConfig, mms_qa_apply
from ..ops import sim_cross_kernels as sk
from ..ops.embed import embed_lookup
from ..parallel.collectives import gather_exact
from ..parallel.mesh import mesh_device
from ..utils.graphs import GraphedCall, on_device
from ..utils.timer import span
from ..utils.tree import tree_map

POOL_DTYPES = ("bf16", "int8", "int4")
INDEX_FORMAT = "mms_answer_selection_tpu_torch.index"
INDEX_VERSION = 1

# pool dtype -> (pack (C, W2, D) tokens -> (pool, aux or None),
#                project (Nq, W1, D) query tokens and W -> operands,
#                score (operands, pool, aux) -> (Nq, C))
_PATHS = {
    "bf16": (lambda t: (sk.pack_candidate_pool(t), None),
             lambda q, w: (sk.project_queries(q, w),),
             lambda proj, pool, aux: sk.bilinear_maxsim_scores(*proj, pool)),
    "int8": (sk.pack_candidate_pool_int8, sk.project_queries_int8,
             lambda proj, pool, aux: sk.bilinear_maxsim_scores_int8(
                 *proj, pool, aux)),
    "int4": (sk.pack_candidate_pool_int4, sk.project_queries_int4,
             lambda proj, pool, aux: sk.bilinear_maxsim_scores_int4(
                 *proj, pool, aux)),
}


def topk(scores: torch.Tensor, k: int):
    """Top-k along the last axis, sorted descending, lower index first
    among equal values, and -0.0 below +0.0, as ``lax.top_k`` orders them.

    Each float32 score maps to an int32 whose order is that total order;
    the index, complemented, fills the low 32 bits of an int64 key, so the
    keys are distinct and ``torch.topk`` on them has one answer."""
    n = scores.shape[-1]
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + (0xFFFFFFFF - idx)
    pos = torch.topk(keys, k, dim=-1).indices
    return torch.gather(scores, -1, pos), pos


def topk_merge(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Merge per-shard top-k lists: (S, Nq, k) -> global (Nq, k)."""
    s, nq, kk = vals.shape
    flat_v = vals.permute(1, 0, 2).reshape(nq, s * kk)
    flat_i = idxs.permute(1, 0, 2).reshape(nq, s * kk)
    top_v, pos = topk(flat_v, k)
    return top_v, torch.gather(flat_i, 1, pos)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 tensors as uint16 bit patterns (numpy has no bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _text(a: np.ndarray) -> str:
    return bytes(a).decode()


class QueryEngine:
    """Learned-metric retrieval over a candidate pool.

    params / state: the model's parameter and BN-state trees as tensors
    (``convert.params_from_numpy``); the engine uses 'embed' and the
    metric 'sim' to score, and the whole model to rerank.
    pool_dtype: "bf16" (the serving default), "int8" (half the bytes,
    about 1% score error; rerank when exactness matters) or "int4" (a
    quarter of the bytes, capacity-only: about 0.6 top-10 agreement with
    bf16, so serve it behind ``query_rerank``).
    chunk_size: candidates packed and scored per step; pools larger than
    this are scored chunk by chunk with an incremental top-k merge.
    scan_chunks: each query path one CUDA graph replay on the card (True,
    the JAX package's default), or eager launches from the host (False;
    module docstring).
    device: where the pool lives and the kernels run (default "cuda", or
    this rank's device on a mesh).
    mesh: split the pool over every rank of this mesh (module docstring).
    """

    def __init__(self, params, cfg: MMSQAConfig, *, pool_dtype: str = "bf16",
                 chunk_size: int = 131072, scan_chunks: bool = True,
                 device=None, mesh=None):
        if cfg.sim_mode != 2:
            raise ValueError("query engine requires the learned bilinear "
                             "metric (sim_mode=2)")
        if pool_dtype not in POOL_DTYPES:
            raise ValueError(f"pool_dtype must be one of {POOL_DTYPES}, got "
                             f"{pool_dtype!r}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.mesh = mesh
        if mesh is not None:
            if mesh.size() != torch.distributed.get_world_size():
                raise ValueError("a meshed engine splits its pool over "
                                 "every rank; the mesh must span them all")
            device = mesh_device(mesh) if device is None else device
        self.device = resolve_device(device)
        self.scan_chunks = bool(scan_chunks)
        self.version = 0          # bumped by every change the graphs read
        # over an NCCL mesh the scan's gather is captured with it; over
        # gloo the queries run eagerly
        self._calls = GraphedCall(self.device, name="engine", mesh=mesh)
        self.params = params
        self.cfg = cfg
        self.pool_dtype = pool_dtype
        self.chunk_size = int(chunk_size)
        self.pool = None          # (capacity, W2P, Dp[/2]) packed rows
        self.aux = None           # int8 / int4 only: (capacity, 2) bf16
        self.pool_size = 0        # rows in use (global on a mesh)
        self._offset = 0          # global index of this rank's row 0
        self.cand_token_ids = None  # (C, W2) on device; None for from-tokens
        self.deleted = torch.zeros(0, dtype=torch.int64)  # sorted, CPU
        self.dead = None          # (rows,) bool on device: this rank's
        #                           tombstones, read by the IVF paths
        self.ivf = None           # set by build_ivf

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._params = tree_map(lambda t: t.to(self.device), value)
        self._changed()

    def _changed(self) -> None:
        """A new version: every graph of the old one is dropped."""
        self.version += 1
        self._calls.drop()

    def _mark_dead(self) -> None:
        """``dead`` anew from ``deleted``, over this rank's rows."""
        dead = torch.zeros(self.pool.shape[0], dtype=torch.bool)
        local = self.deleted - self._offset
        dead[local[(local >= 0) & (local < dead.numel())]] = True
        self.dead = dead.to(self.device)

    # ------------------------------------------------------------------ build
    def build_index(self, candidate_ids, *, reserve: int = 0):
        """candidate_ids: int (C, W2) token ids.  Embeds with the model's
        table and packs the pool chunk by chunk; keeps the ids on the
        device so ``query_rerank`` can gather shortlisted candidates there.

        reserve: extra (masked) rows allocated now, so ``add_candidates``
        fills them in place instead of growing the pool."""
        ids = torch.as_tensor(candidate_ids, device=self.device)
        if ids.ndim != 2 or ids.dtype.is_floating_point:
            raise ValueError(f"candidate_ids must be int (C, W2), got "
                             f"{tuple(ids.shape)} {ids.dtype}")
        self._build(ids.shape[0], reserve, self._embedded(ids))
        self.cand_token_ids = ids
        return self

    def build_index_from_tokens(self, candidate_tokens):
        """candidate_tokens: (C, T, D) precomputed token embeddings in the
        metric's D-dim space, on any device; moved over one chunk at a
        time.  Such a pool has no ids, so no rerank, add or compact."""
        tokens = torch.as_tensor(candidate_tokens)
        if tokens.ndim != 3:
            raise ValueError(f"candidate_tokens must be (C, T, D), got "
                             f"{tuple(tokens.shape)}")
        self._build(tokens.shape[0], 0, lambda a, b: tokens[a:b].to(
            self.device, torch.float32))
        self.cand_token_ids = None
        return self

    def _embedded(self, ids):
        return lambda a, b: embed_lookup(self.params["embed"], ids[a:b])

    def _shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()

    def _build(self, c: int, reserve: int, tokens_of):
        if c < 1 or reserve < 0:
            raise ValueError(f"need at least one candidate and reserve >= 0, "
                             f"got C={c}, reserve={reserve}")
        self.pool = self.aux = None  # free the old pool before packing
        # this rank's global rows [off, off + rows); on one device, all
        rows = -(-(c + reserve) // self._shards())
        off = 0 if self.mesh is None else \
            torch.distributed.get_rank() * rows
        live = min(max(c - off, 0), rows)
        # the first chunk packed fixes the layout; a rank past row 0 packs
        # global row 0 for the layout alone
        first = min(live, self.chunk_size) if off == 0 else 1
        pool, aux = self._pack(tokens_of(0, first))
        self.pool = torch.zeros((rows,) + pool.shape[1:],
                                dtype=pool.dtype, device=self.device)
        if aux is not None:
            self.aux = torch.zeros((rows, 2), dtype=aux.dtype,
                                   device=self.device)
        if off == 0:
            self.pool[:pool.shape[0]] = pool
            if aux is not None:
                self.aux[:aux.shape[0]] = aux
            start = first
        else:
            start = 0
        self._mask_reserve(live)
        self._write_rows(start, live,
                         lambda a, b: tokens_of(off + a, off + b))
        self._offset = off
        self.pool_size = c
        self.deleted = torch.zeros(0, dtype=torch.int64)
        self._mark_dead()
        self.ivf = None
        self._changed()

    def _pack(self, tokens):
        return _PATHS[self.pool_dtype][0](tokens)

    def _write_rows(self, start: int, stop: int, tokens_of):
        """Pack candidates [start, stop) into the allocated pool, one chunk
        at a time."""
        for a in range(start, stop, self.chunk_size):
            b = min(stop, a + self.chunk_size)
            pool, aux = self._pack(tokens_of(a, b))
            self.pool[a:b] = pool
            if aux is not None:
                self.aux[a:b] = aux

    def _mask_reserve(self, start: int):
        if self.aux is None:
            sk.mask_out_candidates(self.pool, start)
        else:
            sk.mask_out_candidates_int8(self.aux, start)

    # ------------------------------------------------------------- lifecycle
    def add_candidates(self, candidate_ids):
        """Append candidates to an ids-built index: only the new rows are
        embedded and packed (each row's packing is its own, so the result
        equals a full rebuild), into the reserve when it has room, else
        into a grown pool (the old rows copied once; bulk adds beat
        row-at-a-time).  Any IVF index is dropped (it does not cover the
        new rows), and so are the graphs (the scan covers new rows).
        Returns the new rows' indices (CPU int64)."""
        if self.pool is None:
            raise ValueError("build_index first")
        if self.mesh is not None:
            raise ValueError("add_candidates is single-device; meshed "
                             "pools rebuild with build_index")
        if self.cand_token_ids is None:
            raise ValueError("add_candidates needs an ids-built index "
                             "(build_index, not build_index_from_tokens)")
        new = torch.as_tensor(candidate_ids, device=self.device)
        w2 = self.cand_token_ids.shape[1]
        if new.ndim != 2 or new.shape[1] != w2 \
                or new.dtype.is_floating_point:
            raise ValueError(f"candidate_ids must be int (N, {w2}) token "
                             f"ids, got {tuple(new.shape)} {new.dtype}")
        old, c = self.pool_size, self.pool_size + new.shape[0]
        ids = torch.cat([self.cand_token_ids,
                         new.to(self.cand_token_ids.dtype)])
        if c > self.pool.shape[0]:
            pool = torch.zeros((c,) + self.pool.shape[1:],
                               dtype=self.pool.dtype, device=self.device)
            pool[:old] = self.pool[:old]
            self.pool = pool
            if self.aux is not None:
                aux = torch.zeros((c, 2), dtype=self.aux.dtype,
                                  device=self.device)
                aux[:old] = self.aux[:old]
                self.aux = aux
        self._write_rows(old, c, self._embedded(ids))
        self.cand_token_ids = ids
        self.pool_size = c
        self._mark_dead()
        self.ivf = None
        self._changed()
        return torch.arange(old, c)

    def remove_candidates(self, rows):
        """Tombstone candidates: their scores fall to the mask (bf16: the
        mask lane of every token; int8 and int4: scale 0 and mask -1e30)
        without touching any other row, and ``k`` is clamped to the live
        rows, so they never surface.  Slots are not reclaimed
        (``compact`` does that)."""
        rows = torch.unique(torch.as_tensor(rows, dtype=torch.int64)
                            .flatten().cpu())
        if rows.numel() == 0:
            return self
        if self.pool is None:
            raise ValueError("build_index first")
        if rows[0] < 0 or rows[-1] >= self.pool_size:
            raise ValueError(f"row out of range [0, {self.pool_size})")
        if self.mesh is not None:  # the rows this rank holds
            mine = rows - self._offset
            r = mine[(mine >= 0) & (mine < self.pool.shape[0])].to(
                self.device)
        else:
            r = rows.to(self.device)
        if self.aux is None:
            sk.mask_candidate_rows(self.pool, r)
        else:
            sk.mask_candidate_rows_int8(self.aux, r)
        self.deleted = torch.unique(torch.cat([self.deleted, rows]))
        self._mark_dead()
        self._changed()
        return self

    @property
    def n_live(self) -> int:
        """Candidates that can still surface in a top-k (pool size minus
        tombstones)."""
        return self.pool_size - self.deleted.numel()

    def compact(self):
        """Keep only the live rows, in order, reclaiming tombstoned slots
        and the reserve (indices shift).  The packed rows are gathered, not
        repacked: each row's packing is its own, so this equals a rebuild
        from the live ids.  Returns the (old pool size,) int64 map old ->
        new index, -1 for removed rows (CPU).  Any IVF index is dropped."""
        if self.pool is None:
            raise ValueError("build_index first")
        if self.cand_token_ids is None:
            raise ValueError("compact needs an ids-built index")
        if self.n_live == 0:
            raise ValueError("no live rows to compact to")
        live = torch.ones(self.pool_size, dtype=torch.bool)
        live[self.deleted] = False
        keep = live.nonzero().flatten()
        mapping = torch.full((self.pool_size,), -1, dtype=torch.int64)
        mapping[keep] = torch.arange(keep.numel())
        keep = keep.to(self.device)
        if self.mesh is not None:  # re-split the live rows over the ranks
            self.build_index(self.cand_token_ids[keep])
            return mapping
        self.pool = self.pool[keep]
        self.aux = None if self.aux is None else self.aux[keep]
        self.cand_token_ids = self.cand_token_ids[keep]
        self.pool_size = keep.numel()
        self.deleted = torch.zeros(0, dtype=torch.int64)
        self._mark_dead()
        self.ivf = None
        self._changed()
        return mapping

    # ------------------------------------------------------------ persistence
    def _params_fingerprint(self) -> str:
        """blake2b digest of what the index bakes in, the embedding table
        then the metric W as float32 bytes: the JAX package's digest of
        the same weights.  A pool packed under other weights mis-scores
        silently, so ``load_index`` refuses a mismatch."""
        h = hashlib.blake2b(digest_size=16)
        for t in (self.params["embed"]["w"], self.params["sim"]["w"]):
            h.update(t.detach().to("cpu", torch.float32).contiguous()
                     .numpy().tobytes())
        return h.hexdigest()

    def _layout(self) -> str:
        """The packed layout this engine scores: candidate-major rows of
        its dtype, Dp lanes (unpacked) for the metric's D."""
        pool, _ = self._pack(torch.zeros((1, 1, self.params["sim"]["w"]
                                          .shape[1]), device=self.device))
        lanes = pool.shape[2] * (2 if self.pool_dtype == "int4" else 1)
        return f"candmaj/{self.pool_dtype}/Dp{lanes}"

    def save_index(self, path: str):
        """Write the built pool (and the IVF index, if any) to ``path`` in
        this package's ``.npz`` format, tagged with its version, layout
        and the weights' fingerprint, so a serving process restarts
        without re-embedding.  The reserve is not saved.  Written to a
        temporary file first, then renamed, so a crash never leaves half
        an index."""
        if self.pool is None:
            raise ValueError("nothing to save; build_index first")
        n = self.pool_size
        data = {
            "format": np.frombuffer(INDEX_FORMAT.encode(), np.uint8),
            "version": np.int64(INDEX_VERSION),
            "layout": np.frombuffer(self._layout().encode(), np.uint8),
            "fingerprint": np.frombuffer(
                self._params_fingerprint().encode(), np.uint8),
            "pool_size": np.int64(n),
            "chunk_size": np.int64(self.chunk_size),
            "deleted": self.deleted.numpy(),
            # a meshed index holds one rank's rows; it reloads only onto a
            # mesh of as many ranks, into the same rank
            "shards": np.int64(self._shards()),
            "shard": np.int64(0 if self.mesh is None
                              else torch.distributed.get_rank()),
        }
        rows = n if self.mesh is None else self.pool.shape[0]
        data["pool"] = self.pool[:rows]
        if self.aux is not None:
            data["aux"] = self.aux[:rows]
        if self.cand_token_ids is not None:
            data["cand_token_ids"] = self.cand_token_ids
        if self.ivf is not None:
            data.update(self.ivf.state())
        arrays = {k: _to_numpy(v) if torch.is_tensor(v) else v
                  for k, v in data.items()}
        bf16 = [k for k, v in data.items()
                if torch.is_tensor(v) and v.dtype == torch.bfloat16]
        arrays["bf16_keys"] = np.frombuffer(",".join(bf16).encode(),
                                            np.uint8)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def load_index(self, path: str):
        """Restore a ``save_index`` file into this engine.  Refuses a file
        of another format or version (an index the JAX package wrote has
        a 128-lane, token-major int8 layout that would mis-score here), of
        another dtype or layout, or packed under other weights."""
        with np.load(path, allow_pickle=False) as z:
            if "format" not in z.files or "layout" not in z.files \
                    or _text(z["format"]) != INDEX_FORMAT:
                raise ValueError(
                    f"{path} has no layout tag of this package's index "
                    f"format; an index written by the JAX package (Dp=128, "
                    f"token-major int8) cannot be scored here, rebuild it "
                    f"with build_index")
            if int(z["version"]) != INDEX_VERSION:
                raise ValueError(f"index version {int(z['version'])} is not "
                                 f"{INDEX_VERSION}")
            layout = _text(z["layout"])
            if layout != self._layout():
                raise ValueError(f"index layout {layout!r} does not match "
                                 f"this engine's {self._layout()!r}")
            if _text(z["fingerprint"]) != self._params_fingerprint():
                raise ValueError(
                    "index was packed under different weights (embed/sim "
                    "fingerprint mismatch); rebuild with build_index")
            saved_shards = int(z["shards"]) if "shards" in z.files else 1
            if saved_shards != self._shards():
                raise ValueError(
                    f"index was packed for {saved_shards} shard(s); this "
                    f"engine's mesh has {self._shards()} — the pool padding "
                    "layout differs, rebuild with build_index")
            shard = int(z["shard"]) if "shard" in z.files else 0
            if self.mesh is not None \
                    and shard != torch.distributed.get_rank():
                raise ValueError(f"index holds shard {shard}; this is rank "
                                 f"{torch.distributed.get_rank()}")
            bf16 = set(_text(z["bf16_keys"]).split(","))

            def get(key):
                a = z[key]
                if key in bf16:
                    return torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16).to(self.device)
                return torch.from_numpy(a).to(self.device)

            self.pool = get("pool")
            self.aux = get("aux") if "aux" in z.files else None
            self.cand_token_ids = (get("cand_token_ids")
                                   if "cand_token_ids" in z.files else None)
            self.pool_size = int(z["pool_size"])
            self._offset = shard * self.pool.shape[0]
            self.chunk_size = int(z["chunk_size"])
            self.deleted = torch.from_numpy(z["deleted"]).to(torch.int64)
            self._mark_dead()
            self.ivf = None
            if "ivf_meta" in z.files:
                from .ivf import IVFIndex
                self.ivf = IVFIndex.restore(self, get)
        self._changed()
        return self

    # ------------------------------------------------------------------ query
    def query_tokens(self, query):
        """(Nq, W1, D) float32 tokens of int (Nq, W1) ids, or the given
        (Nq, W1, D) token embeddings."""
        if self.pool is None:
            raise RuntimeError("build_index first")
        return self._tokens(torch.as_tensor(query, device=self.device))

    def _tokens(self, query):
        return (query.to(torch.float32) if query.ndim == 3
                else embed_lookup(self.params["embed"], query))

    def project(self, q_tokens):
        """The scorer's query operands: ``q_tokens`` projected through the
        metric and quantized as the pool's dtype needs."""
        return _PATHS[self.pool_dtype][1](q_tokens, self.params["sim"]["w"])

    def score(self, proj, pool, aux=None):
        """MaxSim scores (Nq, rows) of ``project``'s operands against packed
        rows of this engine's dtype (a slice or a gather of its pool)."""
        return _PATHS[self.pool_dtype][2](proj, pool, aux)

    def _dispatch(self, key: tuple, body, *args):
        """``body(*args)`` on the device: with ``scan_chunks`` one graph
        replay (eager on the CPU and over a gloo mesh), else eager
        launches.
        ``key``: the path and the ints ``body`` closes over."""
        if not self.scan_chunks:
            return body(*on_device(args, self.device))
        return self._calls(key + (self.chunk_size, self.pool_size), body,
                           *args)

    def query(self, query_ids, k: int = 10):
        """Top-k candidates under the learned metric: (scores (Nq, k'),
        indices (Nq, k')) with k' = min(k, n_live, chunk_size), so a pool
        with fewer live rows than k returns fewer results, never a
        tombstone.  Pools larger than ``chunk_size`` are scored chunk by
        chunk; each chunk's top-k merges into the running one, earlier
        chunk first among equal scores (the lower index, as unchunked).
        On a mesh every rank scores its rows so, and the ranks' top-k
        merge in rank order; every rank returns the merged top-k.  One
        graph replay with ``scan_chunks`` (module docstring).  One
        ``engine.query`` span: the host's dispatch of the call (the key's
        lookup, the copy into the static inputs, the replay's launch and
        the outputs' clones), which returns before the device is done."""
        if self.pool is None:
            raise RuntimeError("build_index first")
        k = min(k, self.n_live, self.chunk_size)
        with span("engine.query"):
            return self._dispatch(("query", k), lambda q: self._scan(q, k),
                                  torch.as_tensor(query_ids))

    def _scan(self, query, k: int):
        """The chunk scan of ``query`` (on the device) for ``k``."""
        proj = self.project(self._tokens(query))
        rows = self.pool_size if self.mesh is None else self.pool.shape[0]
        vals = idx = None
        for a in range(0, rows, self.chunk_size):
            b = min(rows, a + self.chunk_size)
            aux = None if self.aux is None else self.aux[a:b]
            v, ix = topk(self.score(proj, self.pool[a:b], aux), min(k, b - a))
            ix = ix + (a + self._offset)
            if vals is not None:
                v, pos = topk(torch.cat([vals, v], 1), k)
                ix = torch.gather(torch.cat([idx, ix], 1), 1, pos)
            vals, idx = v, ix
        if self.mesh is not None:
            group = torch.distributed.group.WORLD
            vals, idx = topk_merge(gather_exact(vals, group),
                                   gather_exact(idx, group), k)
        return vals, idx

    # ------------------------------------------------- approximate retrieval
    def build_ivf(self, n_clusters: int = 256, *, bucket: int | None = None,
                  kmeans_iters: int = 10, seed: int = 0,
                  coarse_tokens: int = 1):
        """Build an IVF index over the pool (``serve/ivf.py``): k-means
        buckets over the candidates' token means; ``query_ivf`` scores only
        the probed buckets with the exact kernel.  coarse_tokens > 1 also
        keeps a mini pool of that many token centroids per candidate for
        ``ivf.query_coarse``.  bf16 and int8 pools only."""
        from .ivf import IVFIndex
        self.ivf = IVFIndex(self, n_clusters=n_clusters, bucket=bucket,
                            kmeans_iters=kmeans_iters, seed=seed,
                            coarse_tokens=coarse_tokens)
        self._changed()
        return self.ivf

    def query_ivf(self, query_ids, k: int = 10, *, nprobe: int = 8):
        """Approximate top-k via the IVF index (``build_ivf`` first): exact
        kernel scores over the ``nprobe`` best clusters only.  With
        nprobe == n_clusters this equals ``query``."""
        if self.ivf is None:
            raise RuntimeError("build_ivf first")
        return self.ivf.query(query_ids, k=k, nprobe=nprobe)

    # ------------------------------------------------------- exact rescoring
    def query_rerank(self, state, query_ids, k: int = 10, *,
                     shortlist: int = 50, overlap_feat=None):
        """Retrieve, then rerank: the kernel shortlists ``shortlist``
        candidates per query, the full model rescores exactly those pairs,
        and the top-k by P(correct) comes back as (probs (Nq, k'),
        candidate indices (Nq, k')).  shortlist is clamped to the live
        rows (beyond them a shortlist would reach tombstones) and to
        ``chunk_size``, and k to the shortlist.  Needs ``build_index``
        (ids kept).  With ``scan_chunks`` the four steps are one graph
        replay; ``state`` is copied into its buffers each call."""
        if self.cand_token_ids is None:
            raise ValueError(
                "query_rerank needs build_index(candidate_ids); a "
                "from-tokens pool keeps no candidate ids to rescore")
        if self.n_live == 0:
            raise ValueError("no live candidates to rerank")
        shortlist = min(shortlist, self.n_live, self.chunk_size)
        k = min(k, shortlist)
        q = torch.as_tensor(query_ids)
        of = None if overlap_feat is None else torch.as_tensor(overlap_feat)
        if not self.scan_chunks:   # two phases: the shortlist, then rescore
            q, state, of = on_device((q, state, of), self.device)
            _, idx = self.query(q, k=shortlist)
            return self._rescore(state, q, idx, of, k)
        return self._dispatch(
            ("rerank", k, shortlist),
            lambda q, st, of: self._rescore(st, q, self._scan(q, shortlist)[1],
                                            of, k), q, state, of)

    def _rescore(self, state, q, idx, of, k: int):
        """Top-k of the shortlist ``idx`` (Nq, S) by P(correct), the
        candidates gathered on the device."""
        nq, s = idx.shape
        cand = self.cand_token_ids[idx.reshape(-1)]            # (Nq*S, W2)

        def rows(t):          # each query's row repeated S times
            return t[:, None].expand(nq, s, *t.shape[1:]).reshape(
                nq * s, *t.shape[1:])

        probs = self._score_pairs(state, rows(q), cand,
                                  None if of is None else rows(of))
        vals, order = topk(probs.reshape(nq, s), k)
        return vals, torch.gather(idx, 1, order)

    def score_pairs(self, state, query_ids, candidate_ids, overlap_feat=None):
        """P(correct) of the full interaction model for explicit (query,
        candidate) pairs; zero overlap features when none are given."""
        return self._score_pairs(*on_device(
            (state, query_ids, candidate_ids, overlap_feat), self.device))

    def _score_pairs(self, state, q, a, overlap_feat):
        if overlap_feat is None:
            overlap_feat = torch.zeros((q.shape[0], self.cfg.overlap_features),
                                       dtype=torch.float32, device=self.device)
        batch = {"question": q, "answer": a, "overlap_feat": overlap_feat}
        out, _ = mms_qa_apply(self.params, state, batch, self.cfg,
                              train=False)
        return out["prob"][:, 1]
