"""Persistent retrieval service over a ``QueryEngine`` (counterpart of
``serve/server.py``).

The reference's only "serving" story is batch scoring through ``caffe
test`` / a pycaffe forward (tools/caffe.cpp:229-296,
do_trec_qa_clean.py:617-652): load weights, score a file, exit.  This
module is the production path: a long-lived process that owns the device,
keeps the candidate pool packed on it, and answers queries over HTTP --
stdlib ``http.server`` only.

Endpoints (all JSON):

  GET  /healthz  liveness + pool facts
  GET  /stats    latency percentiles over every request since start +
                 counters
  POST /query    {"tokens": [[int,...],...]} or {"text": ["...",...]},
                 optional "k" (default 10), "rerank" (exact-model
                 rescoring shortlist; 0 = single-phase) and "shortlist"
                 (approximate coarse probe via the engine's IVF index;
                 mutually exclusive with rerank).  Scalar forms
                 ("text": "...", one token row) are accepted and
                 auto-batched.  Returns {"results": [{"topk":
                 [[candidate_index, score],...]}, ...],
                 "latency_ms": ...}.
  POST /add      {"tokens": [[ids...],...]} or {"text": [...]} of
                 CANDIDATE rows (answer length): appends to the live
                 pool via engine.add_candidates (drops any IVF index).
                 Returns the new global indices.
  POST /remove   {"rows": [int,...]}: tombstones candidates -- they score
                 below every live row and never surface again.
  POST /compact  rebuilds the pool from the live rows (indices shift).

Raw-text queries are tokenized exactly like the data pipeline
(lowercase whitespace split, OOV -> unknown_idx, center-pad to the
model's question length -- ``data.trec_qa.encode_tokens``), so a server
pointed at a prepped data dir serves the same index space the model was
trained on.

Every device call runs under one lock, and its results come back to the
host (``.cpu().numpy()``) inside it: requests arrive on the server's
threads, the engine's tensors live on one device, and no CUDA tensor ever
reaches ``json``.  With ``batch_window_ms > 0`` concurrent requests that
share (k, rerank, shortlist) coalesce into one device call
(``_MicroBatcher``).  With ``pad_buckets`` (the default, as in the JAX
package) each call's rows are padded with ``pad_idx`` queries up to the
next power of two, at most ``max_batch``, and the filler's results sliced
off: every query row is scored on its own, so the padding changes no
real row's result, and the engine captures one CUDA graph per bucket and
(k, rerank, shortlist) -- at most log2(max_batch) + 1 of them -- where
without it every distinct batch size is a graph of its own (the JAX
package bounds its jit compiles so).

Each server keeps its own ``utils.timer.Recorder`` (``recorder``), so two
servers in one process count apart.  Its spans: ``server.request`` (one
query, from its validated rows to its results on the host; the latency of
``/stats`` and of the reply), ``server.queue`` (a request's wait on the
micro-batcher, its group's call included) and ``server.dispatch`` (the
device call of a group, with the request's id, or the first of its
group's).  Its counters are the counts of ``/stats``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.timer import Recorder

# the JAX package's name of each pool dtype in /healthz
_POOL_DTYPE_NAMES = {"bf16": "bfloat16"}


# the counters of /stats, in its order
_COUNTERS = ("queries_served", "query_rows", "errors", "device_dispatches",
             "device_dispatch_rows")


class _StatsView:
    """``QAServer.stats``: ``snapshot()`` reads the server's recorder."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder

    def snapshot(self) -> dict:
        """The body of ``/stats``: the counters, and the median and 90th
        percentile of ``server.request`` in ms over every request served
        since start (to within 1%), once there is one."""
        out = {name: self.recorder.counter(name) for name in _COUNTERS}
        served = self.recorder.aggregate("server.request")
        if served is not None:
            out["p50_ms"] = served.quantile(0.5) * 1e3
            out["p90_ms"] = served.quantile(0.9) * 1e3
        return out


class _Item:
    __slots__ = ("key", "q", "id", "done", "result", "err")

    def __init__(self, key, q, id):
        self.key = key
        self.q = q
        self.id = id
        self.done = threading.Event()
        self.result = None
        self.err = None


class _MicroBatcher:
    """Coalesce concurrent queries that share a dispatch key (k, rerank)
    into ONE device call.

    Each device call has a fixed host cost (hundreds of launches for one
    query) and the MaxSim kernel's throughput grows with the batch, so
    under concurrent load one (Nq_a + Nq_b)-row call beats two serialized
    ones.  The reference has no serving daemon at all (its batch path is
    ``caffe test``, tools/caffe.cpp:229-296).

    Requests enqueue and a single collector thread drains the queue
    every ``window_ms``; rows from items with the same key are
    concatenated, dispatched once, and the results sliced back per
    item.  Items with distinct keys still ride the same drain cycle but
    dispatch separately (top-k width / rerank shortlist shape the
    compiled program)."""

    def __init__(self, run_group, window_ms: float):
        self.run_group = run_group
        self.window_s = window_ms / 1e3
        self._cv = threading.Condition()
        self._pending: list[_Item] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, key, q, id=None):
        """``q``'s results once its group's call is done; ``id``: the
        request's, which the call's span takes for its group's first."""
        item = _Item(key, q, id)
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self._pending.append(item)
            self._cv.notify()
        item.done.wait()
        if item.err is not None:
            raise item.err
        return item.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=10)

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            if self.window_s > 0:
                time.sleep(self.window_s)  # let concurrent peers arrive
            with self._cv:
                batch, self._pending = self._pending, []
            groups: dict = {}
            for it in batch:
                groups.setdefault(it.key, []).append(it)
            for key, items in groups.items():
                try:
                    qc = np.concatenate([it.q for it in items])
                    vals, idx = self.run_group(key, qc, items[0].id)
                    off = 0
                    for it in items:
                        n = len(it.q)
                        it.result = (vals[off: off + n],
                                     idx[off: off + n])
                        off += n
                except Exception as e:  # noqa: BLE001 -- deliver per item
                    for it in items:
                        it.err = e
                finally:
                    for it in items:
                        it.done.set()


class QAServer:
    """HTTP façade over a built ``QueryEngine``.

    engine: a QueryEngine whose ``build_index`` has run.
    state:  model state (BN stats) -- required for rerank requests.
    vocab_words: index-ordered word array (vocab.npz["words"]) enabling
        "text" queries; unknown_idx/pad_idx follow build_vocab's layout
        (n and n+1, data/trec_qa.py).
    pad_buckets: pad each device call's rows to a power of two (module
        docstring): at most log2(max_batch) + 1 graphs per (k, rerank,
        shortlist); without it a graph per distinct batch size.
    """

    def __init__(self, engine, *, state=None, vocab_words=None,
                 q_len: int | None = None, host: str = "127.0.0.1",
                 port: int = 0, default_k: int = 10,
                 max_batch: int = 1024, batch_window_ms: float = 0.0,
                 pad_buckets: bool = True):
        if engine.pool_size == 0:
            raise ValueError("engine has no index; call build_index first")
        self.engine = engine
        self.state = state
        self.q_len = q_len or engine.cfg.question_len
        self.default_k = default_k
        self.max_batch = max_batch
        self.pad_buckets = pad_buckets
        self.recorder = Recorder()
        self.stats = _StatsView(self.recorder)
        self._device_lock = threading.Lock()
        self.batch_window_ms = float(batch_window_ms)
        self._batcher = (_MicroBatcher(self._dispatch_group,
                                       self.batch_window_ms)
                         if self.batch_window_ms > 0 else None)
        if vocab_words is not None:
            words = [str(w) for w in np.asarray(vocab_words).tolist()]
            self.vocab = {w: i for i, w in enumerate(words)}
            self.unknown_idx = len(words)
            self.pad_idx = len(words) + 1
        else:
            self.vocab = None
            # token rows can still be padded: the engine's vocab tail is
            # [unknown, pad] by build_vocab construction
            self.unknown_idx = engine.cfg.vocab_size - 2
            self.pad_idx = engine.cfg.vocab_size - 1
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; stats carry the signal
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server.health())
                elif self.path == "/stats":
                    self._send(200, server.stats.snapshot())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                routes = {"/query": server.handle_query,
                          "/add": server.handle_add,
                          "/remove": server.handle_remove,
                          "/compact": server.handle_compact}
                handler = routes.get(self.path)
                if handler is None:
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        req = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        raise _BadRequest(f"invalid JSON: {e}") from e
                    payload = handler(req)
                    self._send(200, payload)
                except _BadRequest as e:
                    server.recorder.count("errors")
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 -- keep serving
                    server.recorder.count("errors")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None
        self._started = False

    # ------------------------------------------------------------- public
    def health(self) -> dict:
        eng = self.engine
        return {"ok": True, "pool": int(eng.pool_size),
                "n_live": int(eng.n_live),
                "pool_dtype": _POOL_DTYPE_NAMES.get(eng.pool_dtype,
                                                    eng.pool_dtype),
                "q_len": self.q_len, "text_queries": self.vocab is not None,
                "batch_window_ms": self.batch_window_ms,
                "ivf": eng.ivf is not None,
                **self.stats.snapshot()}

    def start(self):
        """Serve in a background thread (returns immediately)."""
        self._started = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._started = True
        self.httpd.serve_forever()

    def close(self):
        # httpd.shutdown() waits on an event that only serve_forever
        # sets; calling it on a never-started server blocks forever
        if self._started:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._batcher is not None:
            self._batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------ queries
    def encode_texts(self, texts: list[str],
                     length: int | None = None) -> np.ndarray:
        if self.vocab is None:
            raise _BadRequest("server started without a vocabulary; "
                              "send 'tokens' instead of 'text'")
        from ..data.trec_qa import encode_tokens
        length = length or self.q_len
        rows = [encode_tokens(t.lower().split(), self.vocab,
                              self.unknown_idx, self.pad_idx, length)
                for t in texts]
        return np.asarray(rows, np.int32)

    def _pad_tokens(self, rows, length: int | None = None) -> np.ndarray:
        length = length or self.q_len
        out = np.full((len(rows), length), self.pad_idx, np.int32)
        for i, r in enumerate(rows):
            try:
                ids = np.asarray(r, np.int32).ravel()[:length]
            except (TypeError, ValueError) as e:
                raise _BadRequest(f"row {i} of 'tokens' is not an id "
                                  f"list: {e}") from e
            if (ids < 0).any() or (ids >= self.engine.cfg.vocab_size).any():
                raise _BadRequest(
                    f"token ids of row {i} outside [0, "
                    f"{self.engine.cfg.vocab_size})")
            pad_b = max(0, (length - len(ids)) // 2)  # center, like prep
            out[i, pad_b: pad_b + len(ids)] = ids
        return out

    def _candidate_rows(self, req: dict) -> np.ndarray:
        """Parse 'text'/'tokens' as CANDIDATE (answer-length) rows."""
        a_len = self.engine.cfg.answer_len
        if "text" in req:
            texts = req["text"]
            if isinstance(texts, str):
                texts = [texts]
            if not texts or not all(isinstance(t, str) for t in texts):
                raise _BadRequest("'text' must be a string or list of them")
            return self.encode_texts(texts, length=a_len)
        if "tokens" in req:
            rows = req["tokens"]
            if not isinstance(rows, list):
                raise _BadRequest("'tokens' must be a list of ids or a "
                                  "list of id lists")
            if rows and isinstance(rows[0], (int, float)):
                rows = [rows]
            if not rows:
                raise _BadRequest("'tokens' is empty")
            return self._pad_tokens(rows, length=a_len)
        raise _BadRequest("body needs 'text' or 'tokens'")

    # -------------------------------------------------- live pool updates
    def handle_add(self, req: dict) -> dict:
        """POST /add — append candidates to the LIVE pool (engine
        add_candidates: only the tail chunks repack; rebuild-only
        capability, the reference re-embeds its whole split per run).
        Any IVF index is dropped (it does not cover the new rows)."""
        if not isinstance(req, dict):
            raise _BadRequest("body must be a JSON object")
        cand = self._candidate_rows(req)
        had_ivf = self.engine.ivf is not None
        with self._device_lock:
            try:
                new_rows = self.engine.add_candidates(cand)
            except ValueError as e:
                raise _BadRequest(str(e)) from e
        return {"added": [int(i) for i in new_rows],
                "pool": int(self.engine.pool_size),
                "n_live": int(self.engine.n_live),
                "ivf_dropped": bool(had_ivf)}

    def handle_remove(self, req: dict) -> dict:
        """POST /remove — tombstone candidate rows: {"rows": [int,...]}.
        Removed rows score -inf on every path and can never surface."""
        if not isinstance(req, dict):
            raise _BadRequest("body must be a JSON object")
        rows = req.get("rows")
        if not isinstance(rows, list) or not rows or \
                not all(isinstance(r, int) and not isinstance(r, bool)
                        for r in rows):
            raise _BadRequest("'rows' must be a non-empty list of ints")
        with self._device_lock:
            try:
                self.engine.remove_candidates(rows)
            except ValueError as e:
                raise _BadRequest(str(e)) from e
        return {"removed": len(set(rows)),
                "pool": int(self.engine.pool_size),
                "n_live": int(self.engine.n_live)}

    def handle_compact(self, req: dict) -> dict:
        """POST /compact — rebuild the pool from live rows, reclaiming
        tombstoned slots.  CANDIDATE INDICES SHIFT: clients holding old
        indices must re-query (the response carries only counts; the
        full old->new map is engine.compact()'s return value for
        in-process callers)."""
        with self._device_lock:
            try:
                mapping = self.engine.compact().cpu().numpy()
            except ValueError as e:
                raise _BadRequest(str(e)) from e
        return {"pool": int(self.engine.pool_size),
                "reclaimed": int((mapping < 0).sum()),
                "indices_shifted": bool((mapping
                                         != np.arange(len(mapping))).any())}

    def handle_query(self, req: dict) -> dict:
        if not isinstance(req, dict):
            raise _BadRequest("body must be a JSON object")
        try:
            k = int(req.get("k", self.default_k))
            rerank = int(req.get("rerank", 0))
            shortlist = int(req.get("shortlist", 0))
        except (TypeError, ValueError) as e:
            raise _BadRequest(f"'k'/'rerank'/'shortlist' must be "
                              f"integers: {e}") from e
        if k < 1:
            raise _BadRequest(f"k must be >= 1, got {k}")
        if rerank < 0:
            raise _BadRequest(f"rerank must be >= 0, got {rerank}")
        if shortlist < 0:
            raise _BadRequest(f"shortlist must be >= 0, got {shortlist}")
        if shortlist and rerank:
            raise _BadRequest("'shortlist' (approximate coarse probe) "
                              "and 'rerank' are separate modes; send one")
        if shortlist and self.engine.ivf is None:
            raise _BadRequest("server's engine has no IVF index; start "
                              "with build_ivf (serve --ivf-clusters)")
        if "text" in req:
            texts = req["text"]
            if isinstance(texts, str):
                texts = [texts]
            if not texts or not all(isinstance(t, str) for t in texts):
                raise _BadRequest("'text' must be a string or list of them")
            q = self.encode_texts(texts)
        elif "tokens" in req:
            rows = req["tokens"]
            if not isinstance(rows, list):
                raise _BadRequest("'tokens' must be a list of ids or a "
                                  "list of id lists")
            if rows and isinstance(rows[0], (int, float)):
                rows = [rows]
            if not rows:
                raise _BadRequest("'tokens' is empty")
            q = self._pad_tokens(rows)
        else:
            raise _BadRequest("body needs 'text' or 'tokens'")
        if len(q) > self.max_batch:
            raise _BadRequest(f"batch {len(q)} exceeds max_batch "
                              f"{self.max_batch}")
        if rerank and self.state is None:
            raise _BadRequest("rerank needs model state; server "
                              "started without it")
        key = (k, rerank, shortlist)
        with self.recorder.span("server.request") as request:
            if self._batcher is not None:
                with self.recorder.span("server.queue"):
                    vals, idx = self._batcher.submit(key, q, request.id)
            else:
                vals, idx = self._dispatch_group(key, q)
        ms = request.seconds * 1e3
        self.recorder.count("queries_served")
        self.recorder.count("query_rows", len(q))
        return {
            # sentinel slots (index -1, -inf, or the kernels' -1e30
            # additive mask) mean "fewer than k live candidates in the
            # probed set" — drop them rather than emit -Infinity (strict
            # JSON parsers reject it) or mask-magnitude scores
            "results": [
                {"topk": [[int(i), float(v)] for i, v in zip(ri, rv)
                          if i >= 0 and v > -1e29]}
                for ri, rv in zip(idx, vals)],
            "latency_ms": round(ms, 3),
            "k": k,
        }

    def _dispatch_group(self, key, q, id=None) -> tuple:
        """One device call for ``q`` under dispatch key ``(k, rerank,
        shortlist)``, its rows padded to their bucket (``pad_buckets``);
        the results come back to the host under the lock.  ``id``: the
        request the ``server.dispatch`` span is of (default: the request
        whose thread calls)."""
        k, rerank, shortlist = key
        n = n_pad = len(q)
        if self.pad_buckets and n < self.max_batch:
            n_pad = min(1 << (n - 1).bit_length(), self.max_batch)
        if n_pad > n:
            q = np.concatenate([q, np.full((n_pad - n, q.shape[1]),
                                           self.pad_idx, q.dtype)])
        with self.recorder.span("server.dispatch", id=id), \
                self._device_lock:
            if rerank:
                vals, idx = self.engine.query_rerank(
                    self.state, q, k=k, shortlist=rerank)
            elif shortlist:
                vals, idx = self.engine.ivf.query_coarse(
                    q, k=k, shortlist=shortlist)
            else:
                vals, idx = self.engine.query(q, k=k)
            vals = vals.cpu().numpy()  # the host fetch fences the device work
            idx = idx.cpu().numpy()
        self.recorder.count("device_dispatches")
        self.recorder.count("device_dispatch_rows", n_pad)
        return vals[:n], idx[:n]


class _BadRequest(ValueError):
    pass
