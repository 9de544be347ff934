"""Wall-clock timer with start/stop/pause/resume (reference: demo.py:73-120)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.start_time: float | None = None
        self.elapsed_time = 0.0
        self.running = False

    def start(self) -> None:
        if not self.running:
            self.start_time = time.perf_counter()
            self.running = True

    def stop(self) -> float:
        """Stop and return the milliseconds elapsed since the last start."""
        if self.running:
            elapsed = time.perf_counter() - self.start_time
            self.elapsed_time += elapsed
            self.start_time = None
            self.running = False
            return elapsed * 1e3
        return self.elapsed_time * 1e3

    def pause(self) -> None:
        if self.running:
            self.elapsed_time += time.perf_counter() - self.start_time
            self.start_time = None
            self.running = False

    def resume(self) -> None:
        self.start()

    def reset(self) -> None:
        self.start_time = None
        self.elapsed_time = 0.0
        self.running = False

    def get_elapsed_time(self) -> float:
        """Total elapsed seconds."""
        if self.running:
            return self.elapsed_time + (time.perf_counter() - self.start_time)
        return self.elapsed_time
