"""The ahead-of-time surface of the port: CUDA graphs captured once per
signature and replayed, and the precision set-up.

Counterpart of ``aprilsam_tpu/utils/cache.py``.  In the JAX package every
step, superstep, bundle slot and batch epoch runs as one compiled executable
per static signature (the bucketed shapes of its inputs), and ``precompile``
runs dead inputs through each signature so that nothing compiles mid-run.
The port's counterpart of one executable per signature is one CUDA graph per
signature: its launch sequence captured once on buffers of the signature's
padded shapes, then replayed with each dispatch's inputs copied into those
buffers.  A replay costs one launch where the eager body costs one per
operation.

The JAX package's persistent on-disk compilation cache has no counterpart:
a CUDA graph lives in the process that captured it.  What the port keeps on
disk is the build cache of its compiled libraries (utils/build.py).

Rules the cached graphs keep:
  * every input is read from the signature's StaticInputs, and every result
    lands in the solver state (updated in place), in the signature's stats
    buffer or in a workspace that several graphs share (`workspace`: the
    panel epoch's factor between its per-panel graphs); all are allocated
    outside the graphs' memory pool, so that all graphs can share one pool
    (their intermediates never outlive a replay) and replay in any order on
    one stream;
  * a graph is captured after one eager run of its signature on the capture
    stream (library handles, workspaces and K1's function attributes are
    set up there, never inside a capture); that first run is the dispatch's
    own, or precompile's dead one;
  * the capture records the launches of the port's kernels (K1, K2), and
    each replay adds that record to their counts;
  * a reallocation of the solver state drops every graph: the solver bumps
    `generation` where it reallocates, and run() compares the addresses of
    the state's tensors with those the graphs were captured on; each
    generation captures into a pool of its own, so that a dropped
    generation's pool is freed whole (a capacity growth then empties the
    allocator's cache) and never reused at shapes it was not sized for;
  * a capture or a replay that fails raises.  Nothing falls back to the
    eager path; eager is the caller's choice (enabled=False), or the CPU.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from . import trace


def setup_precision() -> None:
    """Keep float32 products in full float32 on the card.

    Counterpart of ``aprilsam_tpu/utils/cache.py:setup_precision``: reduced-
    precision operands made the assembled normal equations indefinite on the
    TPU (DESIGN.md section 3).  The H100's analogue is TF32, which keeps about
    three decimal digits, so it is off for matmul and for cuDNN.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Captured:
    """One signature's graph and the buffers it reads and writes."""

    graph: "torch.cuda.CUDAGraph"
    inputs: object                    # solver.state.StaticInputs
    out: torch.Tensor                 # the stats buffer the graph writes
    k1: Dict[Tuple[int, int, str], int]  # K1 launches per replay, by shape
    k2: Dict[Tuple[int, int, str], int]  # K2 launches per replay, by shape
    seconds: float                    # capture time (eager run excluded)


@dataclass
class GraphCache:
    """Graphs by signature for one solver on one device.  Disabled (every
    dispatch eager) on the CPU and when the caller asks for it."""

    device: torch.device
    enabled: bool = True
    graphs: Dict[Hashable, Captured] = field(default_factory=dict)
    generation: int = 0
    # dispatches through the cache, and those that replayed a graph, by
    # the signature's kind (key[0]); graphs captured
    calls: Counter = field(default_factory=Counter)
    replayed: Counter = field(default_factory=Counter)
    captures: int = 0
    # graphs captured and their capture seconds, by generation
    by_generation: Dict[int, Dict[str, float]] = field(default_factory=dict)
    # tensors that graphs read and write across replays, by name (kept as
    # long as the graphs captured on them)
    buffers: Dict[Hashable, object] = field(default_factory=dict)
    _pool: Optional[tuple] = None
    _stream: Optional["torch.cuda.Stream"] = None
    _addresses: Optional[tuple] = None

    def __post_init__(self):
        self.enabled = self.enabled and self.device.type == "cuda"

    def bump(self) -> None:
        """Drop every graph (their buffers and the state's tensors they
        were captured on may be freed)."""
        self.generation += 1
        self.graphs.clear()
        self.buffers.clear()
        self._addresses = None
        self._pool = None

    def _check_state(self, ds) -> None:
        addresses = tuple(getattr(ds, f.name).data_ptr() for f in fields(ds)
                          if isinstance(getattr(ds, f.name), torch.Tensor))
        if addresses != self._addresses:
            if self.graphs:
                self.bump()
            self._addresses = addresses

    def run(self, key: Hashable, ds, ints: Dict[str, np.ndarray],
            floats: Dict[str, np.ndarray],
            body: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
            ) -> torch.Tensor:
        """One dispatch of signature `key`: body(P) on the uploaded arrays,
        where P maps each array's name to its tensor and body returns the
        dispatch's stats.  Enabled: the signature's graph is replayed (the
        returned tensor is its stats buffer, which the next replay of the
        signature overwrites: copy it before then); the first dispatch of a
        signature runs eagerly, then captures the graph."""
        from ..kernels import frontal_qr, tri_inv
        from ..solver.state import upload

        with trace.span("graphs.dispatch"):
            if not self.enabled:
                with trace.span("graphs.upload"):
                    P = upload(ds, ints, floats)
                return body(P)
            self._check_state(ds)
            self.calls[key[0]] += 1
            cap = self.graphs.get(key)
            if cap is not None:
                with trace.span("graphs.upload"):
                    cap.inputs.load(ints, floats)
                with trace.span("graphs.replay"):
                    cap.graph.replay()
                tri_inv.count_replay(cap.k1)
                frontal_qr.count_replay(cap.k2)
                self.replayed[key[0]] += 1
                return cap.out
            with trace.span("graphs.capture"):
                return self._capture(key, ds, ints, floats, body)

    def _capture(self, key, ds, ints, floats, body) -> torch.Tensor:
        """A signature's first dispatch: its eager run, then the capture
        of its graph."""
        from ..kernels import frontal_qr, tri_inv
        from ..solver.state import StaticInputs, upload

        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        s = self._stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            first = body(upload(ds, ints, floats))
            out = torch.empty_like(first)
            out.copy_(first)
            inputs = StaticInputs(ds, ints, floats)
        with trace.span("graphs.capture_graph"):
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            tri_inv.capture_record = {}
            frontal_qr.capture_record = {}
            try:
                with torch.cuda.stream(s):
                    graph.capture_begin(pool=self._pool)
                    try:
                        out.copy_(body(inputs.P))
                    finally:
                        graph.capture_end()
                k1 = tri_inv.capture_record
                k2 = frontal_qr.capture_record
            finally:
                tri_inv.capture_record = None
                frontal_qr.capture_record = None
            cur.wait_stream(s)
            secs = time.perf_counter() - t0
        self.graphs[key] = Captured(graph, inputs, out, k1, k2, secs)
        self.captures += 1
        gen = self.by_generation.setdefault(
            self.generation, {"captures": 0, "seconds": 0.0})
        gen["captures"] += 1
        gen["seconds"] += secs
        return out

    def workspace(self, key: Hashable, make: Callable[[], object]) -> object:
        """The workspace `key` that graphs share, made once (enabled); a
        fresh one for every call when eager."""
        if not self.enabled:
            return make()
        if key not in self.buffers:
            self.buffers[key] = make()
        return self.buffers[key]

    @property
    def replays(self) -> int:
        return sum(self.replayed.values())
