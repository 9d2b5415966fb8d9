"""Host-to-device frame prefetcher — the port of
gps_slam_tpu/data/prefetch.py.

A background thread stages the next frames on the device while the
current one is processed, and the iterator yields (cam, depth, rgb) in
camera order.  Frames cross in `DeviceFrameCache`'s wire format (rgb888,
u16 depth at 0.2 mm) and are converted by the same ops, so the tensors
equal the cache's bit for bit (the JAX prefetcher stages the raw f32
arrays, which no caller of the JAX package reads).

On the card the thread fills pinned host tensors, copies them with
`non_blocking=True` on a side stream, converts them there and records an
event; the consumer's current stream waits on that event before a frame
is yielded, and the tensors are marked as used on that stream, so neither
a read of a frame nor the allocator's reuse of its memory races the copy.
On the CPU the tensors are plain.
"""

from __future__ import annotations

import queue
import threading

import torch

from .. import resolve_device
from .device_cache import quantize, to_f32


class FramePrefetcher:
    def __init__(self, cams, device=None, lookahead: int = 2):
        self.cams = cams
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, cam):
        rgb_u8, depth = (torch.from_numpy(a) for a in quantize(cam))
        if self._stream is None:
            return to_f32(rgb_u8, depth), None
        with torch.cuda.stream(self._stream):
            rgb_d = rgb_u8.pin_memory().to(self.device, non_blocking=True)
            depth_d = depth.pin_memory().to(self.device, non_blocking=True)
            out = to_f32(rgb_d, depth_d)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, ev

    def _worker(self):
        try:
            for cam in self.cams:
                (rgb, depth), ev = self._stage(cam)
                self._q.put((cam, depth, rgb, ev))
        except Exception as e:  # the consumer re-raises it in its thread
            self._q.put(e)
            return
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            cam, depth, rgb, ev = item
            if ev is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ev)
                depth.record_stream(consumer)
                rgb.record_stream(consumer)
            yield cam, depth, rgb
