"""Which device a run measures: JAX's view of it and nvidia-smi's."""

import subprocess


class NoAccelerator(RuntimeError):
    """JAX found no GPU where the run needs one."""


def device_info(expect_gpu: bool = True) -> dict:
    """Platform, device kind and count of JAX's devices. Raises NoAccelerator
    when a GPU is expected and the first device is anything else."""
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if expect_gpu and info["platform"] != "gpu":
        raise NoAccelerator(
            f"JAX found no GPU (first device: {info['platform']}, "
            f"{info['kind']})"
        )
    return info


def card_info() -> str:
    """`nvidia-smi` name and power limit of every card, from a child process
    that stays off JAX (a card below its 700 W limit runs slower)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else f"nvidia-smi rc={r.returncode}"
