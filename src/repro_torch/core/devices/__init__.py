"""Device-fleet registry: named ``DeviceProfile`` targets for cross-device
prediction.

Static datasheet profiles (``profiles.py``) are pre-registered; calibrated
devices register themselves at run time (``host.py`` /
``BatchPredictor.for_device``).  ``get_profile(name)`` is the single lookup
every ``device=`` parameter in the stack resolves through.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.devices.host import host_profile_from_store
from repro_torch.core.devices.profiles import FLEET, DeviceProfile

__all__ = ["DeviceProfile", "register", "get_profile", "list_devices",
           "host_profile_from_store", "REGISTRY"]

REGISTRY: Dict[str, DeviceProfile] = {p.name: p for p in FLEET}


def register(profile: DeviceProfile, *, overwrite: bool = False) -> DeviceProfile:
    """Add a profile to the fleet.  Re-registering the identical profile is a
    no-op; a conflicting one requires ``overwrite=True``."""
    cur = REGISTRY.get(profile.name)
    if cur is not None and cur != profile and not overwrite:
        raise ValueError(f"device {profile.name!r} already registered with a "
                         f"different profile; pass overwrite=True to replace")
    REGISTRY[profile.name] = profile
    return profile


def get_profile(name: str) -> DeviceProfile:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


def list_devices() -> List[str]:
    return sorted(REGISTRY)
