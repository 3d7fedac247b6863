"""What the compiler made of the port's CUDA kernels: registers, spills and
shared memory from `ptxas -v`, and the instruction counts of the machine
code (SASS) from `cuobjdump`, whole and by loop.

    python -m mvae_tpu_torch.tools.sass_report [--match TEXT] [extra.cu ...]

Compiles every source of `csrc/` (and any extra `.cu` named, for example an
earlier version of a kernel) to a cubin with the flags of `ops/_cuda.py`,
on a machine with the CUDA toolkit; no card is needed. For each kernel
whose demangled name contains TEXT it prints one line:

    [sass] <source> <kernel>: <n> instructions, loops <start-end:count>...;
    <ptxas' line of registers, spills, shared memory>

A loop is the stretch from the target of a backward branch to the branch.
Instructions an element of a streaming kernel: the count of its inner
loop over the elements one trip handles (a trip of bn_normalize's and
bn_dx's stream handles kStreamUnroll chunks of V: 16 elements in bf16, 8
in f32; of bn_moments kUnroll * V).
"""

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from mvae_tpu_torch.ops import _cuda

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA\b.*?\b0x([0-9a-f]+)")


def _tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found: needs the CUDA toolkit")
    return path


def _demangle(names):
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not Path(filt).exists() or not names:
        return dict(zip(names, names))
    out = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def kernels_of(sass: str):
    """{mangled name: [(address, instruction text), ...]} of a cuobjdump
    -sass listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSTR.match(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return out


def loops_of(instrs):
    """[(start address, end address, instructions)] of the backward
    branches, innermost (shortest) first."""
    addrs = [a for a, _ in instrs]
    out = []
    for a, text in instrs:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) < a:     # (a branch to itself pads)
            t = int(m.group(1), 16)
            out.append((t, a, sum(1 for x in addrs if t <= x <= a)))
    return sorted(out, key=lambda l: l[2])


def report(source: Path, match: str, tmp: str):
    cubin = Path(tmp) / (source.stem + ".cubin")
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    log = subprocess.run(
        [_tool("nvcc"), *flags, f"-I{_cuda.CSRC}", "-cubin", str(source),
         "-o", str(cubin)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{log.stdout}"
                           f"{log.stderr}")
    # ptxas -v: "Compiling entry function '<name>'", then its "Used" line
    used, cur = {}, None
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        elif cur and ("Used " in line or "spill" in line):
            used[cur] = (used.get(cur, "") + " "
                         + line.split(":", 1)[-1].strip()).strip()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    kernels = kernels_of(sass)
    names = _demangle(list(kernels))
    for mangled, instrs in kernels.items():
        name = names[mangled]
        if match not in name:
            continue
        loops = " ".join(f"{s:04x}-{e:04x}:{n}"
                         for s, e, n in loops_of(instrs))
        short = re.sub(r"\(.*", "", name.replace("(int)", "").replace(
            "(bool)1", "true").replace("(bool)0", "false"))
        print(f"[sass] {source.parent.name}/{source.name} {short}: "
              f"{len(instrs)} instructions, loops {loops or 'none'}; "
              f"{used.get(mangled, 'no ptxas line')}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="", help="substring of the kernels' "
                    "demangled names to report (default: all)")
    ap.add_argument("extra", nargs="*", type=Path,
                    help="further .cu files to compile and report")
    args = ap.parse_args(argv)
    sources = [_cuda.CSRC / s for s in _cuda.SOURCES] + args.extra
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            report(src, args.match, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
