"""Per-card task-parallel eval sharding.

Counterpart of ``wavjepa_tpu/eval/multidevice.py`` (the reference's
heareval/multigpu.py): read shell commands from stdin and run them over a
pool of cards, each command pinned to one card with
``CUDA_VISIBLE_DEVICES``:

    ls -d embeddings/*/*/ | sed 's|^|python -m wavjepa_tpu_torch.eval predictions |' \\
        | python -m wavjepa_tpu_torch.eval.multidevice --num-devices 4
"""

from __future__ import annotations

import argparse
import os
import queue
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List


def run_command(command: str, device_id: int) -> int:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = str(device_id)
    print(f"[device {device_id}] {command}", flush=True)
    return subprocess.call(command, shell=True, env=env)


def run_commands(commands: List[str], num_devices: int) -> List[int]:
    """Run commands over a pool of exclusive cards: each worker checks a card
    out of a free-list for the duration of its command, so two concurrent
    commands never share one."""
    results: List[int] = [0] * len(commands)
    free: queue.Queue = queue.Queue()
    for device in range(num_devices):
        free.put(device)

    def worker(idx_cmd):
        idx, cmd = idx_cmd
        device = free.get()
        try:
            results[idx] = run_command(cmd, device)
        finally:
            free.put(device)

    with ThreadPoolExecutor(max_workers=num_devices) as pool:
        list(pool.map(worker, enumerate(commands)))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(prog="wavjepa_tpu_torch.eval.multidevice")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="0 = every visible CUDA device")
    args = parser.parse_args(argv)
    n = args.num_devices
    if n <= 0:
        import torch

        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: pass --num-devices")
    commands = [line.strip() for line in sys.stdin if line.strip()]
    codes = run_commands(commands, n)
    return max(codes) if codes else 0


if __name__ == "__main__":
    sys.exit(main())
