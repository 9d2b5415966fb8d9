"""The closed loop: frames of the stream go into the program's
`SLAMPipeline.slam_train_cams` as fast as it takes them.

The program reads its frames through `pipe.frame_cache.get(cam)`; the
benchmark puts `StreamSource` there, which hands out frames that were
made on the device in set-up (`frames.FrameStore`), converted by the
program's own `device_cache.to_f32`, with an LRU of the program's size.
Nothing is rendered or uploaded inside the window.

The pipeline asks for a step's new frames, then calls the engine once
for them (`process_frames_gt`: a fusion group; `process_frame`: one
frame) and, where the step ends at an optimisation frame, runs the window
before it asks for the next frame.  So a step starts at the first
request of a frame that no earlier request named, and ends where the next
one starts: the program has synchronised by then (the group's
`_sync`, the window's read of its counts).  `StreamSource` records each
step's start and frame count at those points and moves the run through
its phases there: set-up, the timed window, the profiled slice, the
check step, and the end of the stream (`EndOfStream`, raised before the
next step takes anything).
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch


class EndOfStream(Exception):
    """The stream has no more frames; raised at a step boundary."""


class Phases:
    SETUP, WINDOW, TRACE, CHECK, DONE = "setup", "window", "trace", "check", "done"


class LazyCams:
    """The stream's cameras, made on first use and kept, so the pipeline
    sees one object per frame (it compares cameras by identity)."""

    def __init__(self, n: int, make):
        self._n, self._make, self._cams = n, make, {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int):
        if not 0 <= k < self._n:
            raise IndexError(k)
        cam = self._cams.get(k)
        if cam is None:
            cam = self._cams[k] = self._make(k)
        return cam


class StreamSource:
    """`frame_cache` of the pipeline, the step clock and the phase
    switch.  `hooks` maps a phase change to a callable run at that
    boundary, before the step that follows takes anything:
    "window" (set-up ends), "trace" (the window ends, profiling starts),
    "check" (the window or the slice ends, or a check step follows
    another: the state before the check step), "check_again" (asked when
    a check step has run: True for one more) and "done" (the last check
    step has run)."""

    def __init__(self, store, to_f32, warmup_frames: int, seconds: float,
                 trace_frames: int, hooks: dict, sync, capacity: int = 256,
                 on_boundary=None):
        self.store, self.to_f32, self.sync = store, to_f32, sync
        self.warmup_frames, self.seconds = int(warmup_frames), float(seconds)
        self.trace_frames = int(trace_frames)
        self.hooks = hooks
        self.on_boundary = on_boundary
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()
        self.newest = -1
        self.pending = 0          # frames asked for and not yet handed to the engine
        self.phase = Phases.SETUP
        self.steps: list[tuple] = []   # (phase, start s, first frame, frames)
        self.t_window = self.t_window_end = None
        self.phase_start_frame = {}

    # the pipeline's interface -------------------------------------------------

    def get(self, cam):
        k = cam.id
        out = self._cache.get(k)
        if out is not None:
            self._cache.move_to_end(k)
            return out
        if k > self.newest:
            if self.pending == 0:
                self._boundary(k)
            self.pending += 1
            self.newest = k
            if self.steps:
                ph, t, first, n = self.steps[-1]
                self.steps[-1] = (ph, t, first, n + 1)
        out = self.to_f32(*self.store.wire(k))
        self._cache[k] = out
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return out

    def consumed(self) -> None:
        """The engine has been handed the pending frames."""
        self.pending = 0

    # phases -------------------------------------------------------------------

    def _enter(self, phase: str, k: int) -> None:
        self.phase = phase
        self.phase_start_frame[phase] = k
        hook = self.hooks.get(phase)
        if hook is not None:
            hook()

    def _boundary(self, k: int) -> None:
        now = time.perf_counter()
        if self.phase == Phases.SETUP and k >= self.warmup_frames:
            self.sync()
            now = time.perf_counter()
            self.t_window = now
            self._enter(Phases.WINDOW, k)
        elif self.phase == Phases.WINDOW and now - self.t_window >= self.seconds:
            self.sync()
            self.t_window_end = time.perf_counter()
            self._enter(Phases.TRACE if self.trace_frames > 0 else Phases.CHECK, k)
            now = time.perf_counter()
        elif (self.phase == Phases.TRACE
              and k - self.phase_start_frame[Phases.TRACE] >= self.trace_frames):
            self.sync()
            self._enter(Phases.CHECK, k)
            now = time.perf_counter()
        elif self.phase == Phases.CHECK and self.steps[-1][0] == Phases.CHECK:
            self.sync()
            again = self.hooks.get("check_again")
            if again is not None and again():
                self._enter(Phases.CHECK, k)
            else:
                self._enter(Phases.DONE, k)
                raise EndOfStream()
        if self.on_boundary is not None:
            self.on_boundary(self.phase)
        self.steps.append((self.phase, now, k, 0))

    # readings -----------------------------------------------------------------

    def window_steps(self) -> list[tuple]:
        """(start s, end s, frames) of every step of the timed window."""
        out = []
        for i, (ph, t, _, n) in enumerate(self.steps):
            if ph != Phases.WINDOW:
                continue
            nxt = self.steps[i + 1] if i + 1 < len(self.steps) else None
            end = self.t_window_end if nxt is None or nxt[0] != Phases.WINDOW else nxt[1]
            out.append((t, end, n))
        return out


def wrap_engine(engine, source: StreamSource) -> None:
    """Note on the source when the engine takes the pending frames."""
    for name in ("process_frames_gt", "process_frame"):
        fn = getattr(engine, name)

        def call(*a, _fn=fn, **kw):
            source.consumed()
            return _fn(*a, **kw)

        setattr(engine, name, call)


def device_sync(device) -> callable:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
