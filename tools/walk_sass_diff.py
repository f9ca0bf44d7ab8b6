#!/usr/bin/env python3
"""Is the walk kernel's count-min code the same as an older source's?

    python3 tools/walk_sass_diff.py OLD_SRC

Run from the root of a checkout on a machine with the CUDA toolkit (no card
is needed).  Builds the port's count-min walk libraries (``-DWALK_PART=1``
and ``=2``, as ``ops/_build.py`` builds them) and OLD_SRC (an older
``csrc/walk_greedy.cu``, e.g. from ``git show``) with the port's nvcc
flags, disassembles both with ``cuobjdump -sass``, and compares the machine
code of every ``walk_greedy_kernel`` instantiation that both hold,
instruction by instruction, as disassembled and again with the
constant-bank offsets masked (what differs only there reads another
offset of the kernel's parameters).  Prints one line a instantiation
(identical, or the count of differing instructions) and, last, a JSON
summary; exits 0 when every instantiation is identical as disassembled.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rnabloom_tpu_torch.ops import _build  # noqa: E402

KERNEL = re.compile(r"Function : (\S*walk_greedy_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d)E\S*)")
# an instruction line: /*0040*/ OPCODE operands ; /* encoding */
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);")
CBANK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def build(src: str, defines: list, out: str) -> str:
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, src, "-o", out],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


def kernels(lib: str) -> dict:
    """Instantiation (layout, num_hash, deep, mode) -> its instructions."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        m = KERNEL.search(line)
        if m:
            key = tuple(int(g) for g in m.groups()[1:])
            out[key] = []
            continue
        m = INSN.search(line)
        if m and key is not None:
            out[key].append(m.group(1).strip())
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    old_src = argv[0]
    tmp = tempfile.mkdtemp(prefix="walk_sass_")
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build, _build.WALK_SRC, ["-DWALK_PART=1"], os.path.join(tmp, "new1.so")),
                pool.submit(build, _build.WALK_SRC, ["-DWALK_PART=2"], os.path.join(tmp, "new2.so")),
                pool.submit(build, old_src, [], os.path.join(tmp, "old.so"))]
        new1, new2, old = (j.result() for j in jobs)
    new = {**kernels(new1), **kernels(new2)}
    before = kernels(old)
    names = ("greedy", "pair", "naive")
    def ndiff(a, b):
        return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

    def masked(code):
        return [CBANK.sub("c[0x0][...]", x) for x in code]

    same, differ, masked_same = [], [], 0
    for key in sorted(set(new) & set(before)):
        a, b = new[key], before[key]
        n, nm = ndiff(a, b), ndiff(masked(a), masked(b))
        what = f"layout {key[0]} num_hash {key[1]} deep {key[2]} {names[key[3]]}"
        print(f"{what}: {'identical' if n == 0 else f'{n} of {max(len(a), len(b))} instructions differ'}"
              f"{'' if n == 0 else f', {nm} with constant-bank offsets masked'} ({len(a)} / {len(b)} instructions)")
        (same if n == 0 else differ).append(what)
        masked_same += nm == 0
    only_old = sorted(set(before) - set(new))
    print(json.dumps({"compared": len(same) + len(differ), "identical": len(same),
                      "identical_offsets_masked": masked_same, "differ": differ,
                      "only_in_old": [list(k) for k in only_old]}))
    return 0 if not differ and not only_old else 1


if __name__ == "__main__":
    sys.exit(main())
