"""Token streaming for the serving front end (counterpart of
``paddle_tpu/serving/streaming.py``).

- :class:`StreamEvent`: one stream element, the tokens a decode tick
  committed for a request (kind ``"token"``) or a request's terminal
  record (kind ``"end"``, carrying the final status).
- :class:`TokenStream`: the iterator ``generate_stream`` and
  ``serve_stream`` return. It wraps the serve-loop generator;
  `cancel(r)` evicts one request at the next loop iteration (its KV
  pages return to the pool, ``last_status[r] == "cancelled"``), and
  closing the stream cancels everything still pending the same way, so
  a consumer that stops iterating cannot leak pages or slots.
- :class:`ServeRequest`: the work item of
  ``ContinuousBatchingPredictor.serve_stream``: a prompt with its own
  token budget, tier, deadline, sampling parameters and an opaque
  `meta` that rides through to its events.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

__all__ = ["StreamEvent", "TokenStream", "ServeRequest"]


class StreamEvent(NamedTuple):
    """One element of a token stream.

    `request` is the index within the originating call (or the running
    intake index for `serve_stream`); `index` is the 1-based ordinal of
    the token within its request (0 on "end"); `ts` is the wall-clock
    time of the request span's last event (its `serve.request` span's
    clock, so stream and trace agree), or time.time() at emission past
    the span's event cap or with telemetry off; `status` is the terminal
    status on "end" events (ok /
    deadline / shed / cancelled / watchdog / rejected_*); `meta` is the
    ServeRequest.meta passthrough (None for the list-based API).

    **Token spans.** One "token" event is emitted per DECODE TICK, not
    per token: with speculative decoding a tick commits several tokens
    at once, and `span` carries the whole tuple in order. `token` is
    the span's LAST token and `index` its ordinal, so single-token
    consumers keep working unchanged (`span == (token,)` on ordinary
    ticks). Consumers that must see every token iterate `span`; the
    first span token's ordinal is ``index - len(span) + 1``."""
    request: int
    kind: str                      # "token" | "end"
    token: Optional[int] = None
    index: int = 0
    ts: float = 0.0
    status: Optional[str] = None
    meta: object = None
    span: tuple = ()


class ServeRequest(NamedTuple):
    """Dynamic-intake work item for ContinuousBatchingPredictor
    .serve_stream: one request with its own budget/tier/deadline.
    `deadline_s` is seconds from the moment the serve loop first sees
    the request. `meta` rides through to every StreamEvent.
    `sampling` is an optional generation.sampling.SamplingParams —
    per-request temperature/top-k/top-p/seed served as batched operands
    by the on-device sampling decode program (the predictor must be
    constructed with ``sampling_enabled=True``; None = greedy).
    `trace` is an optional `observability.TraceContext` (the router's
    admission-minted identity): the request's `serve.request` span
    parents on it and joins the submitter's trace instead of rooting
    under the serve call's `serve.generate` span."""
    prompt: List[int]
    max_new_tokens: int = 32
    tier: Optional[str] = None
    deadline_s: Optional[float] = None
    meta: object = None
    sampling: object = None
    trace: object = None


class TokenStream:
    """Iterator over a serve loop's StreamEvents with cancellation.

    Produced by `generate_stream` / `serve_stream`. Iterating drives
    the serve loop (admission, decode dispatch, resolution) — the loop
    only advances while the consumer pulls. `results`/`status` are
    filled in place as requests finish and are complete once the
    iterator is exhausted; `drain()` consumes the rest and returns
    `results`.

    Cancellation: `cancel(r)` marks one request (None = all); at the
    serve loop's next iteration the request is evicted, its pages are
    released, and an "end" event with status "cancelled" is emitted.
    `close()` (also called on leaving a ``with`` block) cancels every
    still-pending request synchronously: pool refcounts return to
    baseline.
    """

    def __init__(self, gen, results: List, status: List, cancel_set: set):
        self._gen = gen
        self.results = results
        self.status = status
        self._cancel = cancel_set
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> StreamEvent:
        try:
            return next(self._gen)
        except StopIteration:
            self._closed = True
            raise

    def cancel(self, request: Optional[int] = None):
        """Cancel one request (or all with None). Takes effect at the
        serve loop's next iteration; safe to call from another thread
        than the consumer's (set.add is atomic under the GIL)."""
        if request is None:
            self._cancel.add("*")
        else:
            self._cancel.add(int(request))

    def close(self):
        """Cancel everything still pending and finish the loop NOW:
        runs the generator's cleanup (page release, status "cancelled")
        synchronously."""
        if self._closed:
            return
        self._closed = True
        self._cancel.add("*")
        # advance once so the loop observes the cancel and evicts with
        # page release (generator .close() alone would only unwind)
        try:
            for _ in self._gen:
                pass
        except Exception:
            pass
        self._gen.close()

    def drain(self) -> List:
        """Consume the remaining events and return `results`."""
        for _ in self:
            pass
        return self.results

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
