"""Generalized lean containers (§5.2) -> LeanExecutorPool.

On the GPU the analogue of containerization cost is getting an entry point
ready to run: building a kernel library with nvcc, capturing a CUDA graph,
or any other one-time setup of a callable for one (arch, entrypoint,
shape) signature.  The pool keeps those built callables, so a fork_resume
can skip straight to execution — exactly how SOCK's pooled lean containers
let MITOSIS skip cgroup/namespace setup.
"""
from __future__ import annotations

import time
from typing import Callable, Dict


class LeanExecutorPool:
    def __init__(self):
        self._cache: Dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.build_time = 0.0

    def get(self, key: tuple, builder: Callable[[], Callable]) -> Callable:
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        t0 = time.perf_counter()
        fn = builder()
        self.build_time += time.perf_counter() - t0
        self._cache[key] = fn
        return fn

    def prewarm(self, key: tuple, builder: Callable[[], Callable]) -> None:
        self.get(key, builder)

    def clear(self) -> None:
        self._cache.clear()


GLOBAL_EXECUTOR_POOL = LeanExecutorPool()
