"""SASS instruction counts of the SW and traceback kernels' row loops.

    python3 scripts/sass_sw_torch.py [extra.cu ...]

Compiles biokanga_tpu_torch/csrc/banded_sw.cu and sw_trace.cu (and any
further .cu files given, e.g. an older copy of banded_sw.cu) to cubins
with the package's nvcc flags plus -Xptxas -v, disassembles them with
`cuobjdump -sass` (the listings go to build/sass/) and prints, for every
kernel, its registers and spills, its instruction count and that of its
row loop: the largest span closed by a backward branch that holds a warp
shuffle, vote or reduction (and the size of every such span, for the
decode's inner loops).  The loop span includes its rare paths (a new
best cell, the word stores every 16 rows), so its count is an upper
bound of what one row issues.  For kernels whose steps are unrolled
32 at a time around one warp reduction each (the uhamming sweep's locus
steps), it also counts the instructions of each basic block that holds
32 REDUX instructions, over 32 (`step_bodies`): a step's instructions,
also where the compiler interleaves the steps.  The last line
is one JSON object with the counts.  Needs nvcc and cuobjdump (the CUDA
toolkit), no card.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from biokanga_tpu_torch import kernels  # noqa: E402

OUT = ROOT / "build" / "sass"
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_BRA = re.compile(r"0x([0-9a-f]+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path(kernels._nvcc()).parent / name
    if cand.exists():
        return str(cand)
    raise FileNotFoundError(f"{name} not found")


def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (FileNotFoundError, subprocess.CalledProcessError):
        return names


def _functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Kernel name -> [(address, opcode, operands)]."""
    funcs: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m[1], [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m[1], 16), m[3], m[4]))
    return funcs


def loops(insns) -> list[tuple[int, int, list[str]]]:
    """(first, last address, opcodes) of every span closed by a backward
    branch that holds a warp shuffle, vote or reduction, NOPs left out."""
    out = []
    for addr, op, rest in insns:
        m = _BRA.search(rest)
        if not op.startswith("BRA") or not m or int(m[1], 16) >= addr:
            continue
        lo = int(m[1], 16)
        body = [o for a, o, _ in insns if lo <= a <= addr and o != "NOP"]
        if any(o.startswith(("SHFL", "VOTE", "REDUX")) for o in body):
            out.append((lo, addr, body))
    return out


def step_bodies(insns, steps: int = 32) -> list[float]:
    """For kernels whose locus steps are unrolled `steps` at a time, one
    warp reduction a step (the uhamming sweep): for each run of `steps`
    REDUX instructions, the instructions (NOPs left out) of the basic
    block that holds the run, over `steps`: a step's instructions, the
    refill code around the block not counted."""
    insns = [x for x in insns if x[1] != "NOP"]
    targets = {int(m[1], 16) for _, o, rest in insns
               if o.startswith("BRA") for m in [_BRA.search(rest)] if m}
    at = [k for k, (_, o, _) in enumerate(insns) if o.startswith("REDUX")]
    out = []
    for b in range(0, len(at) - steps + 1, steps):
        lo, hi = at[b], at[b + steps - 1]
        while lo > 0 and insns[lo][0] not in targets and \
                not insns[lo - 1][1].startswith(("BRA", "BSYNC", "EXIT")):
            lo -= 1
        while hi + 1 < len(insns) and insns[hi + 1][0] not in targets and \
                not insns[hi][1].startswith(("BRA", "EXIT")):
            hi += 1
        out.append(round((hi - lo + 1) / steps, 2))
    return out


def _hist(body: list[str]) -> dict[str, int]:
    hist: dict[str, int] = {}
    for o in body:
        key = o.split(".")[0]
        hist[key] = hist.get(key, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1])[:12])


def _kernel_name(demangled: str) -> str:
    """The name with its template arguments, without the parameters."""
    cut = demangled.rfind(">(")
    name = demangled[:cut + 1] if cut >= 0 else demangled.split("(")[0]
    return name.replace("(anonymous namespace)::", "").replace(
        "<unnamed>::", "").replace("void ", "")


def main(argv: list[str]) -> int:
    nvcc, cuobjdump = kernels._nvcc(), _tool("cuobjdump")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = [kernels.CSRC / "banded_sw.cu", kernels.CSRC / "sw_trace.cu"]
    sources += [Path(p).resolve() for p in argv]
    result = {}
    for i, src in enumerate(sources):
        cubin = OUT / f"{i}_{src.stem}.cubin"
        ptxas = subprocess.run(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
             str(cubin), str(src)], capture_output=True, text=True)
        if ptxas.returncode:
            print(ptxas.stdout + ptxas.stderr, file=sys.stderr)
            return 1
        log = ptxas.stdout + ptxas.stderr
        usage = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                           r"registers", log, re.S)
        regs = dict(usage)
        spills = dict(re.findall(r"Compiling entry function '(\S+)'.*?(\d+) "
                                 r"bytes spill stores", log, re.S))
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        (OUT / f"{i}_{src.stem}.sass").write_text(sass)
        funcs = _functions(sass)
        names = list(funcs)
        for mangled, name in zip(names, _demangle(names)):
            spans = loops(funcs[mangled])
            key = f"{i}:{src.name}:{_kernel_name(name)}"
            outer = max(spans, key=lambda s: len(s[2]), default=(0, 0, []))
            result[key] = {
                "registers": int(regs.get(mangled, -1)),
                "spill_bytes": int(spills.get(mangled, 0)),
                "instructions": sum(o != "NOP" for _, o, _ in funcs[mangled]),
                "row_loop": len(outer[2]), "row_loop_ops": _hist(outer[2]),
                "step_bodies": step_bodies(funcs[mangled]),
                "loops": [[hex(lo), hex(hi), len(b)] for lo, hi, b in spans]}
            print(f"{key}: {result[key]['registers']} registers, "
                  f"{result[key]['spill_bytes']} B spills, "
                  f"{result[key]['instructions']} instructions, largest "
                  f"loop {len(outer[2])}: {result[key]['row_loop_ops']}; "
                  f"warp-collective loops {result[key]['loops']}; "
                  f"instructions a step of each 32-step body "
                  f"{result[key]['step_bodies']}")
    print(json.dumps({"sass": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
