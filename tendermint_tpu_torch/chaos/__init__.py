"""Fault injection: the port's copy of the device level of
tendermint_tpu/chaos/ (chaos/device.py). The reference's network and process
levels (the engine, the schedule, the harnesses) are ROADMAP A5.
"""

from tendermint_tpu_torch.chaos.device import DeviceFaultError, DeviceFaultInjector

__all__ = ["DeviceFaultError", "DeviceFaultInjector"]
