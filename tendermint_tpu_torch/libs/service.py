"""Service lifecycle base (reference: libs/service/service.go:24): the
port's copy of tendermint_tpu/libs/service.py, whole.

Start/Stop/Reset semantics with atomic started/stopped flags: Start on a
started service errors, Stop is idempotent, Reset is only legal on a stopped
service. Async-native: on_start/on_stop are coroutines; wait_stopped() parks
until the service stops (the reference's Quit() channel)."""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

logger = logging.getLogger("tendermint_tpu_torch.service")


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class NotStartedError(ServiceError):
    pass


class BaseService:
    """Subclasses override on_start / on_stop (and optionally on_reset)."""

    def __init__(self, name: str = ""):
        self._name = name or type(self).__name__
        self._started = False
        self._stopped = False
        self._quit: Optional[asyncio.Event] = None

    # -- state --------------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    def is_running(self) -> bool:
        return self._started and not self._stopped

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """reference: service.go:139 Start."""
        if self._started:
            if self._stopped:
                raise AlreadyStoppedError(f"{self._name} already stopped")
            raise AlreadyStartedError(f"{self._name} already started")
        self._started = True
        self._quit = asyncio.Event()
        logger.debug("starting %s", self._name)
        try:
            await self.on_start()
        except BaseException:
            self._started = False
            self._quit = None
            raise

    async def stop(self) -> None:
        """Idempotent once started; stopping a never-started service is an
        error (reference: service.go:171 Stop returns ErrNotStarted)."""
        if not self._started:
            raise NotStartedError(f"{self._name} has not been started")
        if self._stopped:
            return
        self._stopped = True
        logger.debug("stopping %s", self._name)
        try:
            await self.on_stop()
        finally:
            if self._quit is not None:
                self._quit.set()

    async def reset(self) -> None:
        """Only legal on a stopped service (reference: service.go:198 Reset)."""
        if not self._stopped:
            raise ServiceError(f"cannot reset running service {self._name}")
        self._started = False
        self._stopped = False
        self._quit = None
        await self.on_reset()

    async def wait_stopped(self) -> None:
        """Park until stop() completes (reference: Quit channel + Wait)."""
        if self._quit is None:
            raise NotStartedError(self._name)
        await self._quit.wait()

    # -- overridables -------------------------------------------------------

    async def on_start(self) -> None:  # noqa: B027
        pass

    async def on_stop(self) -> None:  # noqa: B027
        pass

    async def on_reset(self) -> None:  # noqa: B027
        pass
