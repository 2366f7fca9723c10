"""Count chosen opcodes in the compiled kernels, on a machine with the
CUDA toolkit.

    python -m dcf_torch.tools.sass_summary [NAME ...]

Builds the kernel library if needed, disassembles it with
`cuobjdump -sass`, and prints per kernel whose mangled name contains one
of NAME (default: selection_mma, fusion_fwd) the count of each opcode
family that shows how it was compiled: the tensor-core instructions
(HGMMA, IGMMA, HMMA, IMMA), TMA (UTMALDG, UBLKCP), mbarrier waits
(SYNCS), register reallocation (USETMAXREG), local-memory spills (STL,
LDL), atomics (ATOM: ATOMG / ATOMS, RED: reductions to memory; REDUX,
a warp's reduction in registers, also counts there), and one example
line of each.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from dcf_torch.ops import _cuda

FAMILIES = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG", "UBLKCP", "SYNCS",
            "USETMAXREG", "WARPGROUP", "STL", "LDL", "ATOM", "RED")
_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def kernels_sass(path=None):
    """(mangled name, SASS) of each kernel in a built library: the kernel
    library (built first if needed) by default."""
    if path is None:
        _cuda.library()
        path = _cuda.LIB_PATH
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        yield block.split("\n", 1)[0].strip(), block


def opcodes(block: str) -> collections.Counter:
    """Instructions of one kernel's SASS by opcode (modifiers dropped)."""
    return collections.Counter(m.group(1).split(".")[0]
                               for m in _OP.finditer(block))


def summary(names=("selection_mma", "fusion_fwd")):
    """{kernel: ({family: count}, {family: first line})}."""
    out = {}
    for name, block in kernels_sass():
        if not any(n in name for n in names):
            continue
        counts, first = collections.Counter(), {}
        for line in block.splitlines():
            m = _OP.search(line)
            if not m:
                continue
            fam = next((f for f in FAMILIES if m.group(1).startswith(f)),
                       None)
            if fam:
                counts[fam] += 1
                first.setdefault(fam, line.split(";")[0].strip() + " ;")
        out[name] = (dict(counts), first)
    return out


def main(argv=None) -> int:
    names = tuple(argv if argv is not None else sys.argv[1:]) or (
        "selection_mma", "fusion_fwd")
    for name, (counts, first) in summary(names).items():
        print(name, flush=True)
        print("   ", counts, flush=True)
        for fam, line in first.items():
            print(f"    {fam}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
