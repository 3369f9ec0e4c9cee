"""Async job API: submit / try_get / free over device and host work
(counterpart of `wavespec_tpu/runtime/jobs.py`).

The bridge's async job surface (`gpu_submit_extract_cycles` /
`gpu_try_get_cycles` / `gpu_free_job`, `Include/imports.mqh:12-18`; client
queue `1.1.0:344-356,1266-1411`) on PyTorch:

- **Device jobs**: `submit` calls the function, which enqueues its
  kernels on the current CUDA stream and returns tensors, then records a
  `torch.cuda.Event` on that stream; `try_get` asks the event
  (`query()`, no wait) and `result` waits on it (`synchronize()`). Every
  job runs on the one current stream, in submission order, as JAX's
  dispatch runs on one device queue: the port fills device caches on
  first use (the extractor modules, the sliding DFT's tables, B3's
  twiddles) on that stream, and a job on a side stream could read them
  while their copies are still in flight. A job whose path reads a
  device value on the host (`.item()`, ESPRIT's host roots, a numpy
  conversion) waits for the card inside `submit`: such a job is mostly
  done when `submit` returns.
- **Host jobs** (file IO, staging, decode) run on the native C++ worker
  pool (`native/wavespec_rt.cpp`) when it is available, else on a Python
  ThreadPoolExecutor.

The depth cap mirrors `InpAsyncDepth` (64): submissions beyond it raise,
as the reference frees and skips on overflow (`1.1.0:1333-1337`).
"""

from __future__ import annotations

import ctypes
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

import torch

from wavespec_tpu_torch.runtime import native


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a job's result: a tensor, or tuples, lists and
    dicts of them (other leaves are skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tensor_leaves(item)]
    return []


class _DeviceJob:
    """A submitted function's result and the event recorded after it on
    the stream of its CUDA tensors (None when it holds none)."""

    def __init__(self, out):
        self.out = out
        self.event = None
        cuda = [t for t in tensor_leaves(out) if t.is_cuda]
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda[0].device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.out


class JobQueue:
    """Bridge-style job table over device work on the current stream and
    host workers."""

    def __init__(self, depth: int = 64, host_workers: int = 2):
        self.depth = depth
        self._lock = threading.Lock()
        self._next_id = 1
        self._jobs: dict[int, Any] = {}
        self._host_pool: ThreadPoolExecutor | None = None
        self._host_workers = host_workers
        self._native = native.load()
        self._native_refs: dict[int, tuple[Any, Any]] = {}
        self._native_results: dict[int, Any] = {}
        if self._native is not None:
            self._native.ws_init(host_workers)

    # ------------------------------------------------------------- device

    def submit(self, fn: Callable, *args) -> int:
        """Run `fn(*args)` (its kernels queue on the current stream) and
        return a job id; the job is ready when its device work is done."""
        with self._lock:
            if len(self._jobs) >= self.depth:
                raise RuntimeError(f"job queue full (depth={self.depth})")
            job_id = self._next_id
            self._next_id += 1
        job = _DeviceJob(fn(*args))
        with self._lock:
            self._jobs[job_id] = job
        return job_id

    def try_get(self, job_id: int):
        """(ready, result_or_None) without blocking."""
        with self._lock:
            if job_id in self._native_results:
                return True, self._native_results[job_id]
            job = self._jobs.get(job_id)
        if job is None:
            if job_id in self._native_refs:
                return self._native_try_get(job_id)
            raise KeyError(f"unknown job {job_id}")
        if isinstance(job, Future):
            return (True, job.result()) if job.done() else (False, None)
        return (True, job.out) if job.ready() else (False, None)

    def result(self, job_id: int):
        """Blocking fetch (the reference's Sleep(1) drain, `1.1.0:1342`)."""
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None and job_id in self._native_refs:
            while True:
                ready, res = self._native_try_get(job_id)
                if ready:
                    return res
                time.sleep(0.001)  # the reference's Sleep(1) drain cadence
        if job is None:
            raise KeyError(f"unknown job {job_id}")
        if isinstance(job, Future):
            return job.result()
        return job.wait()

    def free(self, job_id: int) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            self._native_results.pop(job_id, None)
            ref = self._native_refs.pop(job_id, None)
        if ref is not None and self._native is not None:
            self._native.ws_free_job(ref[0])

    def pending(self) -> int:
        with self._lock:
            return len(self._jobs) + len(self._native_refs)

    # --------------------------------------------------------------- host

    def submit_host(self, fn: Callable, *args) -> int:
        """Run host-side work on the native worker pool (or a thread pool)."""
        with self._lock:
            if len(self._jobs) + len(self._native_refs) >= self.depth:
                raise RuntimeError(f"job queue full (depth={self.depth})")
            job_id = self._next_id
            self._next_id += 1

        if self._native is not None:
            holder: dict[str, Any] = {}

            @native.JOB_FN
            def trampoline(_):
                try:
                    holder["result"] = fn(*args)
                except Exception as exc:  # noqa: BLE001 - marshalled to caller
                    holder["error"] = exc

            nid = ctypes.c_int32(0)
            st = self._native.ws_submit_job(trampoline, None, ctypes.byref(nid))
            native.Status.raise_for(st, native.last_error())
            with self._lock:
                # keep the trampoline alive until freed
                self._native_refs[job_id] = (nid.value, (trampoline, holder))
            return job_id

        if self._host_pool is None:
            self._host_pool = ThreadPoolExecutor(max_workers=self._host_workers)
        fut = self._host_pool.submit(fn, *args)
        with self._lock:
            self._jobs[job_id] = fut
        return job_id

    def _native_try_get(self, job_id: int):
        with self._lock:
            nid, (_tramp, holder) = self._native_refs[job_id]
        ready = ctypes.c_int32(0)
        self._native.ws_try_get_job(nid, ctypes.byref(ready))
        if not ready.value:
            return False, None
        if "error" in holder:
            raise holder["error"]
        res = holder.get("result")
        with self._lock:
            self._native_results[job_id] = res
        return True, res

    def shutdown(self) -> None:
        if self._host_pool is not None:
            self._host_pool.shutdown(wait=True)
        with self._lock:
            refs = list(self._native_refs.values())
        if self._native is not None:
            for nid, _keepalive in refs:
                # ws_free_job BLOCKS until the pool has executed the job
                # (workers drain the queue), so the ctypes trampoline in
                # _keepalive stays referenced for as long as C code can
                # still call it: clearing the refs first would let GC
                # free the trampoline under a queued job (segfault), and
                # never freeing would leak the pool's Job entries.
                self._native.ws_free_job(nid)
        with self._lock:
            self._jobs.clear()
            self._native_refs.clear()
            self._native_results.clear()
