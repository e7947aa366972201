"""Subprocess helper (parity with pyutils/cmd.py runSystemCMD; the port's
copy of spatialaudiogen_tpu.utils.cmd)."""

from __future__ import annotations

import subprocess


def run_system_cmd(cmd, check: bool = True, dry_run: bool = False):
    """Run a shell command list/string; returns (stdout, stderr) text."""
    if isinstance(cmd, str):
        cmd_list = cmd.split()
    else:
        cmd_list = list(cmd)
    if dry_run:
        print(" ".join(cmd_list))
        return " ".join(cmd_list), ""
    proc = subprocess.run(cmd_list, capture_output=True, text=True)
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"Command failed ({proc.returncode}): {' '.join(cmd_list)}\n{proc.stderr}")
    return proc.stdout, proc.stderr
