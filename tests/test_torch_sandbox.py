"""The port's stage jail (utils/sandbox.py) on the CPU: the BPF programs it
assembles equal the JAX package's byte for byte (the default deny list,
named deny lists, allow_thread_clone, strict allow lists), and each jail
bites in a spawned child: the deny list, the default deny against fork and
exec, threads allowed while processes are not, the strict allow list,
rlimits, namespaces (or the host's refusal, reported), and `enter`; then a
jailed stage of a topology runs and heartbeats, and `run --processes
--sandbox --cpu` runs the jailed leader end to end (modelled on
tests/test_sandbox.py, which forks its children).

A filter is irrevocable for the process that installs it, so every jail is
entered in a child started by spawn; the child reports by its exit code.
"""

import errno
import multiprocessing as mp
import os
import subprocess
import sys
import time

import pytest

from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.stage import Stage
from firedancer_tpu_torch.utils import sandbox as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_program(monkeypatch, fn, *args, **kwargs) -> tuple[bytes, int]:
    """The program the JAX package's `fn` would install, captured at its
    install call (nothing is installed)."""
    from firedancer_tpu.utils import sandbox as jsb

    got = []
    monkeypatch.setattr(jsb, "_install_filter", lambda prog, n: got.append((prog, n)))
    n = getattr(jsb, fn)(*args, **kwargs)
    assert got and got[0][1] == n
    return got[0]


@pytest.mark.parametrize("case", ["default", "default-threads", "named", "named-threads",
                                  "clone-only-threads", "errno"])
def test_deny_program_bytes_match_jax(monkeypatch, case):
    kw = {}
    args = ()
    if case.startswith("named"):
        args = (["mkdir", "symlink", "unlink"],)
    if case == "clone-only-threads":
        args = (["clone", "clone3", "execve"],)
    if case.endswith("threads"):
        kw["allow_thread_clone"] = True
    if case == "errno":
        kw["errno"] = errno.EACCES
    mine = sb.deny_program(*args, **kw)
    assert mine == _jax_program(monkeypatch, "seccomp_deny", *args, **kw)
    assert len(mine[0]) == 8 * mine[1]


@pytest.mark.parametrize("allow", [["read", "write", "exit_group"],
                                   ["read", "write", "close", "exit", "exit_group", "futex",
                                    "mmap", "munmap", "brk", "rt_sigreturn", "ioctl"]])
def test_allow_program_bytes_match_jax(monkeypatch, allow):
    mine = sb.allow_program(allow)
    assert mine == _jax_program(monkeypatch, "seccomp_allow_only", allow)
    assert mine == sb.allow_program([sb.SYSCALLS[n] for n in allow])


def test_tables_match_jax():
    from firedancer_tpu.utils import sandbox as jsb

    assert sb.SYSCALLS == jsb.SYSCALLS and sb.DEFAULT_DENY == jsb.DEFAULT_DENY
    with pytest.raises(sb.SandboxError):
        sb.deny_program(["no_such_syscall"])


# -- each jail bites, in a spawned child ---------------------------------------


def _spawned(fn) -> int:
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_child, args=(fn,))
    p.start()
    p.join(timeout=120)
    if p.is_alive():
        p.kill()
        p.join()
        raise AssertionError("the jailed child hung")
    return p.exitcode


def _child(fn) -> None:
    try:
        code = fn()
    except BaseException:
        code = 99
    os._exit(code)


def deny_named():
    sb.seccomp_deny(["mkdir", "symlink"])
    try:
        os.mkdir(f"/nonexistent_sb_{os.getpid()}/x")
        return 1
    except PermissionError:
        pass
    except FileNotFoundError:
        return 4  # the filter did not answer first
    with open("/dev/null", "wb") as f:
        f.write(b"ok")  # everything else passes
    return 0


def default_deny():
    sb.seccomp_deny()
    try:
        os.fork()
        return 1
    except OSError:
        pass
    try:
        os.execv("/bin/true", ["/bin/true"])
        return 2
    except OSError:
        return 0


def threads_not_processes():
    sb.seccomp_deny(allow_thread_clone=True)
    import threading

    box = []
    t = threading.Thread(target=lambda: box.append(1))
    t.start()
    t.join()
    if box != [1]:
        return 1
    try:
        os.fork()
        return 2
    except OSError:
        pass
    try:
        os.execv("/bin/true", ["/bin/true"])
        return 3
    except OSError:
        return 0


def allow_only():
    sb.seccomp_allow_only(["read", "write", "close", "exit", "exit_group", "rt_sigreturn",
                           "fstat", "lseek", "mmap", "munmap", "brk", "futex", "sigaltstack",
                           "rt_sigaction", "rt_sigprocmask", "getpid", "ioctl"])
    try:
        os.mkdir(f"/nonexistent_sb_{os.getpid()}/x")
        return 1
    except PermissionError:
        pass
    except OSError:
        return 4
    os.write(2, b"")
    return 0


def rlimits():
    import resource

    sb.set_rlimits(nofile=64, core=0)
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    return 0 if soft == hard == 64 else 1


def namespaces():
    try:
        sb.unshare_namespaces(user=True, net=True)
    except sb.SandboxError as e:
        return 42 if e.errno in (errno.EPERM, errno.EINVAL, errno.ENOSPC) else 1
    import socket

    return 0 if {n for _, n in socket.if_nameindex()} <= {"lo"} else 3


def enter_all():
    rep = sb.enter(rlimits={"nofile": 128}, namespaces={"user": True, "net": True})
    if not rep["rlimits"] or rep["seccomp"] <= 0:
        return 1
    try:
        os.execv("/bin/true", ["/bin/true"])
        return 2
    except OSError:
        return 0


@pytest.mark.parametrize("fn", [deny_named, default_deny, threads_not_processes, allow_only,
                                rlimits, enter_all], ids=lambda f: f.__name__)
def test_the_jail_bites_in_a_spawned_child(fn):
    assert _spawned(fn) == 0


def test_namespaces_in_a_spawned_child_or_the_hosts_refusal():
    rc = _spawned(namespaces)
    assert rc in (0, 42)  # 42: the host refuses user namespaces, reported by SandboxError


# -- a jailed stage of a topology ------------------------------------------------


class JailProbe(Stage):
    """Proves on its first sweep that the jail bites (exec fails), then
    iterates."""

    checked = False

    def after_credit(self):
        if not self.checked:
            try:
                os.execv("/bin/true", ["/bin/true"])
            except OSError:
                self.checked = True
                return
            os._exit(7)  # unreachable unless the jail let exec through


def build_jailed(links, cnc):
    return JailProbe("jailed", cnc=cnc)


def test_a_jailed_topology_stage_runs_and_heartbeats():
    topo = ft.Topology(device="cpu")
    topo.stage("jailed", build_jailed, sandbox={"rlimits": {"nofile": 256}})
    h = ft.launch(topo)
    try:
        assert h.supervise(until=lambda hh: hh.cncs["jailed"].diag(Stage.DIAG_ITER) > 0,
                           timeout_s=120, heartbeat_timeout_s=30)
        i1 = h.cncs["jailed"].diag(Stage.DIAG_ITER)
        time.sleep(0.3)
        assert h.supervise(until=lambda hh: hh.cncs["jailed"].diag(Stage.DIAG_ITER) > i1,
                           timeout_s=30)
        assert h.procs["jailed"].is_alive()
        h.halt()
        assert h.procs["jailed"].exitcode == 0
    finally:
        h.close()


def test_run_processes_sandbox_on_the_cpu():
    """The CLI's jailed leader: every child under the deny list with threads
    allowed, 32 txns executed, the monitor table printed, exit 0."""
    p = subprocess.run([sys.executable, "-m", "firedancer_tpu_torch", "run", "--processes",
                        "--sandbox", "--cpu", "--txns", "32", "--batch", "16"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    assert "(sandboxed)" in p.stderr
    out = p.stdout
    for st in ("benchg", "verify0", "pack", "bank0", "poh", "shred", "store"):
        assert f"\n{st} " in out or out.startswith(f"{st} ") or f"\n{st}" in out, out
    assert "# 32 txns executed" in out
