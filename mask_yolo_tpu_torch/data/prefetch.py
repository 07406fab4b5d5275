"""Host→device batch prefetching — port of `mask_yolo_tpu/data/prefetch.py`.

A background thread assembles batch N+1 (target encoding), copies it into
pinned host memory and starts its host→device copy on a side stream while
the device computes batch N. Before the training step uses a batch, the
compute stream waits on the copy's event, and each tensor is recorded on the
compute stream, so the caching allocator does not reuse its memory while
the step still reads it. On the CPU the batches pass through as tensors.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """A numpy batch dict as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class DevicePrefetcher:
    """Iterate a BatchGenerator-like source (`__len__`, `__getitem__` → dict
    of numpy arrays) as dicts of tensors on `device`, staging `size` batches
    ahead."""

    def __init__(self, source, device, size: int = 2):
        self.source = source
        self.device = torch.device(device)
        self.size = size

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        if self.device.type != "cuda":
            for i in range(len(self.source)):
                yield to_device(self.source[i], self.device)
            return
        q: queue.Queue = queue.Queue(maxsize=self.size)
        err = []
        stop = threading.Event()
        copy_stream = torch.cuda.Stream(self.device)

        def put(item) -> bool:
            """q.put that gives up once the consumer abandoned iteration, so
            the worker never blocks forever on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with torch.cuda.device(self.device), torch.cuda.stream(copy_stream):
                    for i in range(len(self.source)):
                        if stop.is_set():
                            return
                        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                                for k, v in self.source[i].items()}
                        batch = {k: v.to(self.device, non_blocking=True)
                                 for k, v in host.items()}
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                        if not put((batch, done)):
                            return
            except Exception as e:  # surfaced in the consumer thread
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            compute = torch.cuda.current_stream(self.device)
            while True:
                item = q.get()
                if item is None:
                    break
                batch, done = item
                compute.wait_event(done)
                for v in batch.values():
                    v.record_stream(compute)
                yield batch
            t.join()
        finally:
            # on break, on generator close (the consumer raised or returned
            # early) and on garbage collection of a half-consumed iterator
            stop.set()
        if err:
            raise err[0]
