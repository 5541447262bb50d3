"""Process sandbox: seccomp-BPF syscall filters, rlimits, namespaces (the
port's copy of firedancer_tpu/utils/sandbox.py, byte for byte in the BPF
programs it installs).

The classic BPF filter is assembled here instruction by instruction and
installed with prctl(PR_SET_SECCOMP) through ctypes, so nothing depends on
libseccomp.  A Python stage needs a far wider syscall surface than a C
tile, so the default posture is an explicit DENY list of the syscalls that
matter for containment (spawning processes and programs, ptrace,
privilege and filesystem escalation), failing with EPERM; `seccomp_allow_only`
is the strict allowlist.  `deny_program` and `allow_program` build the
programs without installing them.  Entry order: rlimits -> unshare ->
no_new_privs -> seccomp, the filter last so the setup may use anything.

A stage on the card keeps its CUDA context working in the jail: the CUDA driver
needs ioctl and mmap on /dev/nvidia* (neither is in DEFAULT_DENY) and
creates threads (allow_thread_clone, the default of `enter`).
"""

from __future__ import annotations

import ctypes
import errno as _errno
import resource
import struct

# -- kernel ABI constants (x86_64) -------------------------------------------

PR_SET_NO_NEW_PRIVS = 38
PR_SET_SECCOMP = 22
SECCOMP_MODE_FILTER = 2

BPF_LD_W_ABS = 0x20
BPF_JMP_JEQ_K = 0x15
BPF_JMP_JSET_K = 0x45
BPF_RET_K = 0x06

CLONE_THREAD = 0x10000
_DATA_OFF_ARG0_LO = 16  # seccomp_data.args[0], low dword (LE)

SECCOMP_RET_ALLOW = 0x7FFF0000
SECCOMP_RET_ERRNO = 0x00050000
SECCOMP_RET_KILL_PROCESS = 0x80000000

AUDIT_ARCH_X86_64 = 0xC000003E
_DATA_OFF_NR = 0
_DATA_OFF_ARCH = 4

CLONE_NEWNS = 0x00020000
CLONE_NEWUSER = 0x10000000
CLONE_NEWPID = 0x20000000
CLONE_NEWNET = 0x40000000
CLONE_NEWIPC = 0x08000000
CLONE_NEWUTS = 0x04000000

# x86_64 syscall numbers (stable kernel ABI)
SYSCALLS = {
    "fork": 57, "vfork": 58, "clone": 56, "clone3": 435,
    "execve": 59, "execveat": 322,
    "ptrace": 101, "process_vm_readv": 310, "process_vm_writev": 311,
    "kexec_load": 246, "kexec_file_load": 320,
    "mount": 165, "umount2": 166, "pivot_root": 155, "chroot": 161,
    "setuid": 105, "setgid": 106, "setreuid": 113, "setregid": 114,
    "setresuid": 117, "setresgid": 119, "capset": 126,
    "init_module": 175, "finit_module": 313, "delete_module": 176,
    "reboot": 169, "swapon": 167, "swapoff": 168,
    "open_by_handle_at": 304, "userfaultfd": 323, "perf_event_open": 298,
    "bpf": 321, "keyctl": 250, "add_key": 248, "request_key": 249,
    "mkdir": 83, "symlink": 88, "unlink": 87, "rename": 82,
    "socket": 41, "connect": 42, "bind": 49, "listen": 50,
    "read": 0, "write": 1, "close": 3, "exit": 60, "exit_group": 231,
    "mmap": 9, "munmap": 11, "brk": 12, "mprotect": 10,
    "rt_sigreturn": 15, "futex": 202, "openat": 257, "fstat": 5,
    "lseek": 8, "getpid": 39, "gettid": 186, "sched_yield": 24,
    "clock_gettime": 228, "clock_nanosleep": 230, "nanosleep": 35,
    "epoll_wait": 232, "epoll_pwait": 281, "poll": 7, "ppoll": 271,
    "recvfrom": 45, "sendto": 44, "recvmsg": 47, "sendmsg": 46,
    "fsync": 74, "madvise": 28, "getrandom": 318, "sigaltstack": 131,
    "rt_sigaction": 13, "rt_sigprocmask": 14, "ioctl": 16,
}

# the default deny set: no new processes or programs, no debugging other
# processes, no privilege or mount/namespace escalation
DEFAULT_DENY = (
    "fork", "vfork", "clone", "clone3", "execve", "execveat",
    "ptrace", "process_vm_readv", "process_vm_writev",
    "kexec_load", "kexec_file_load", "mount", "umount2", "pivot_root",
    "chroot", "setuid", "setgid", "setreuid", "setregid", "setresuid",
    "setresgid", "init_module", "finit_module", "delete_module",
    "reboot", "swapon", "swapoff", "open_by_handle_at", "userfaultfd",
    "bpf", "keyctl", "add_key", "request_key",
)


class SandboxError(OSError):
    pass


_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    return _libc


def _ins(code: int, jt: int, jf: int, k: int) -> bytes:
    return struct.pack("<HBBI", code, jt, jf, k & 0xFFFFFFFF)


def _install_filter(prog_bytes: bytes, n_ins: int) -> None:
    libc = _get_libc()
    if libc.prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) != 0:
        raise SandboxError(ctypes.get_errno(), "PR_SET_NO_NEW_PRIVS failed")
    buf = ctypes.create_string_buffer(prog_bytes, len(prog_bytes))

    class SockFprog(ctypes.Structure):
        _fields_ = [("len", ctypes.c_ushort), ("filter", ctypes.c_void_p)]

    fprog = SockFprog(n_ins, ctypes.cast(buf, ctypes.c_void_p))
    # the kernel copies the program during the prctl
    if libc.prctl(PR_SET_SECCOMP, SECCOMP_MODE_FILTER, ctypes.byref(fprog), 0, 0) != 0:
        raise SandboxError(ctypes.get_errno(), "PR_SET_SECCOMP failed")


def _resolve(names) -> list[int]:
    out = []
    for n in names:
        nr = SYSCALLS.get(n) if isinstance(n, str) else int(n)
        if nr is None:
            raise SandboxError(_errno.EINVAL, f"unknown syscall {n!r}")
        out.append(nr)
    return out


def deny_program(syscalls=DEFAULT_DENY, *, errno: int = _errno.EPERM,
                 allow_thread_clone: bool = False) -> tuple[bytes, int]:
    """The deny-list filter, (program bytes, instruction count): the named
    syscalls fail with `errno`, everything else passes.  With
    allow_thread_clone, clone(2) with CLONE_THREAD in its flags passes
    even when the clone family is denied (threads yes, processes no), and
    clone3, whose flags sit behind a pointer BPF cannot follow, answers
    ENOSYS so glibc creates threads with clone."""
    nrs = _resolve(syscalls)
    thread_clause = allow_thread_clone and SYSCALLS["clone"] in nrs
    if thread_clause:
        nrs = [x for x in nrs if x not in (SYSCALLS["clone"], SYSCALLS["clone3"])]
    n = len(nrs)
    # with the thread clause:
    #   0 ld arch | 1 jeq arch else KILL | 2 ld nr
    #   3 jeq clone3 -> ENOSYS | 4 jeq clone else +2
    #   5 ld args[0].lo | 6 jset CLONE_THREAD -> ALLOW else DENY
    #   7 ld nr | 8..8+n-1 jeq deny_i -> DENY
    #   then: ALLOW | DENY(errno) | ENOSYS | KILL
    ins = [_ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_ARCH)]
    body_extra = 6 if thread_clause else 0
    ins.append(_ins(BPF_JMP_JEQ_K, 0, n + 3 + body_extra, AUDIT_ARCH_X86_64))
    ins.append(_ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_NR))
    if thread_clause:
        ins.append(_ins(BPF_JMP_JEQ_K, n + 6, 0, SYSCALLS["clone3"]))
        ins.append(_ins(BPF_JMP_JEQ_K, 0, 2, SYSCALLS["clone"]))
        ins.append(_ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_ARG0_LO))
        ins.append(_ins(BPF_JMP_JSET_K, n + 1, n + 2, CLONE_THREAD))
        ins.append(_ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_NR))
    for i, nr in enumerate(nrs):
        ins.append(_ins(BPF_JMP_JEQ_K, n - i, 0, nr))  # hit -> DENY
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_ALLOW))
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_ERRNO | (errno & 0xFFFF)))
    if thread_clause:
        ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_ERRNO | _errno.ENOSYS))
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_KILL_PROCESS))
    return b"".join(ins), len(ins)


def allow_program(syscalls, *, errno: int = _errno.EPERM) -> tuple[bytes, int]:
    """The strict allowlist filter, (program bytes, instruction count):
    only the named syscalls pass; the rest fail with `errno` (not KILL: the
    interpreter's rare syscalls should fail loudly, not end the process)."""
    nrs = _resolve(syscalls)
    n = len(nrs)
    ins = [
        _ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_ARCH),
        _ins(BPF_JMP_JEQ_K, 0, n + 3, AUDIT_ARCH_X86_64),
        _ins(BPF_LD_W_ABS, 0, 0, _DATA_OFF_NR),
    ]
    for i, nr in enumerate(nrs):
        ins.append(_ins(BPF_JMP_JEQ_K, n - i, 0, nr))  # hit -> ALLOW
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_ERRNO | (errno & 0xFFFF)))
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_ALLOW))
    ins.append(_ins(BPF_RET_K, 0, 0, SECCOMP_RET_KILL_PROCESS))
    return b"".join(ins), len(ins)


def seccomp_deny(syscalls=DEFAULT_DENY, *, errno: int = _errno.EPERM,
                 allow_thread_clone: bool = False) -> int:
    """Install deny_program's filter; returns its instruction count."""
    prog, n = deny_program(syscalls, errno=errno, allow_thread_clone=allow_thread_clone)
    _install_filter(prog, n)
    return n


def seccomp_allow_only(syscalls, *, errno: int = _errno.EPERM) -> int:
    """Install allow_program's filter; returns its instruction count."""
    prog, n = allow_program(syscalls, errno=errno)
    _install_filter(prog, n)
    return n


def set_rlimits(*, nofile: int | None = 256, nproc: int | None = None,
                core: int | None = 0, fsize: int | None = None,
                data: int | None = None) -> None:
    """Clamp resource limits (soft and hard, never above the hard limit)."""
    for res, val in (
        (resource.RLIMIT_NOFILE, nofile),
        (resource.RLIMIT_NPROC, nproc),
        (resource.RLIMIT_CORE, core),
        (resource.RLIMIT_FSIZE, fsize),
        (resource.RLIMIT_DATA, data),
    ):
        if val is None:
            continue
        _soft, hard = resource.getrlimit(res)
        want = min(val, hard) if hard != resource.RLIM_INFINITY else val
        resource.setrlimit(res, (want, want))


def unshare_namespaces(*, user: bool = True, net: bool = False, mount: bool = False,
                       ipc: bool = False, uts: bool = False) -> None:
    """unshare(2) into fresh namespaces (a user namespace first makes the
    rest unprivileged-legal).  Raises SandboxError where the host forbids
    them."""
    flags = 0
    if user:
        flags |= CLONE_NEWUSER
    if net:
        flags |= CLONE_NEWNET
    if mount:
        flags |= CLONE_NEWNS
    if ipc:
        flags |= CLONE_NEWIPC
    if uts:
        flags |= CLONE_NEWUTS
    if not flags:
        return
    if _get_libc().unshare(flags) != 0:
        raise SandboxError(ctypes.get_errno(), f"unshare(0x{flags:x}) failed")


def enter(*, deny=DEFAULT_DENY, rlimits: dict | None = None, namespaces: dict | None = None,
          strict_allow=None, allow_thread_clone: bool = True) -> dict:
    """The stage jail, in order: rlimits, namespaces, then the seccomp
    filter.  Returns what engaged.  A namespace the host refuses is
    reported, not raised (hosts without user namespaces); a seccomp
    failure raises, since a policy that silently does not filter is worse
    than a crash."""
    report = {"rlimits": False, "namespaces": False, "seccomp": 0}
    if rlimits is not None:
        set_rlimits(**rlimits)
        report["rlimits"] = True
    if namespaces is not None:
        try:
            unshare_namespaces(**namespaces)
            report["namespaces"] = True
        except SandboxError:
            report["namespaces"] = False
    if strict_allow is not None:
        report["seccomp"] = seccomp_allow_only(strict_allow)
    elif deny:
        report["seccomp"] = seccomp_deny(deny, allow_thread_clone=allow_thread_clone)
    return report
