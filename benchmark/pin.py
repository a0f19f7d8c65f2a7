"""Pin this process to the CPUs local to the visible card, before torch is
imported, as a launch-bound frame loop is deployed on a multi-socket host.

Reads the card's PCI address from ``nvidia-smi --query-gpu=pci.bus_id`` and
its NUMA-local CPUs from ``/sys/bus/pci/devices/<addr>/local_cpulist``.
Imports nothing but the standard library.
"""
from __future__ import annotations

import os
import subprocess


def parse_cpulist(text: str) -> set[int]:
    """'0-3,8,10-11' -> {0, 1, 2, 3, 8, 10, 11}."""
    cpus = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def sysfs_address(bus_id: str) -> str:
    """nvidia-smi's '00000000:1B:00.0' -> sysfs's '0000:1b:00.0'."""
    dom, _, rest = bus_id.strip().partition(":")
    return f"{dom[-4:]}:{rest}".lower()


def _bus_ids():
    """PCI addresses of the cards in CUDA's default order: nvidia-smi's,
    or where it answers [N/A] the driver's /proc entries, else the NVIDIA
    display controllers in sysfs."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        ids = [sysfs_address(b) for b in out.split() if ":" in b]
        if ids:
            return ids, "nvidia-smi"
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        ids = sorted(d.lower() for d in os.listdir("/proc/driver/nvidia/gpus"))
        if ids:
            return ids, "/proc/driver/nvidia/gpus"
    except OSError:
        pass
    ids = []
    base = "/sys/bus/pci/devices"
    try:
        for d in sorted(os.listdir(base)):
            with open(f"{base}/{d}/vendor") as f:
                vendor = f.read().strip()
            with open(f"{base}/{d}/class") as f:
                cls = f.read().strip()
            if vendor == "0x10de" and cls[:6] in ("0x0300", "0x0302"):
                ids.append(d)
    except OSError:
        pass
    return ids, "sysfs"


def card_cpus() -> tuple[set[int] | None, str]:
    """(CPUs local to the first visible card, or None; what was read)."""
    ids, how = _bus_ids()
    if not ids:
        return None, "no card's PCI address found"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0]
    bus = ids[int(visible)] if visible.isdigit() and int(visible) < len(ids) \
        else ids[0]
    path = f"/sys/bus/pci/devices/{bus}/local_cpulist"
    try:
        with open(path) as f:
            cpus = parse_cpulist(f.read())
    except OSError as e:
        return None, f"{path} unreadable ({e})"
    return cpus, f"card {bus} from {how}: {path}"


def pin() -> str:
    """Set this process's affinity to the card-local CPUs that it may use.
    Returns the line to print: what it pinned to, or why it did not."""
    cpus, how = card_cpus()
    if not cpus:
        return f"[pin] not pinned: {how}"
    allowed = os.sched_getaffinity(0)
    use = cpus & allowed
    if not use:
        return f"[pin] not pinned: {how} lists {sorted(cpus)}, none allowed " \
               f"({sorted(allowed)})"
    os.sched_setaffinity(0, use)
    return f"[pin] pinned to {sorted(use)} of {len(allowed)} allowed ({how})"
