"""The loops of a CUDA kernel as compiled: each backward branch in the SASS
of the named functions (`cuobjdump -sass`), with the instructions between
its target and itself counted by opcode. This is how the instructions a rep
of the elementwise chain (`csrc/elementwise_chain.cu`) are read: the reps
loop is the longest loop of each `chain_kernel<MODE>`.

    python -m video_rep_learning_tpu_torch.tools.sass_loops SOURCE_OR_LIB [--function NAME]

SOURCE_OR_LIB is a built library (`build/kernels/<name>-<hash>.so`) or a
`.cu` source, which is compiled first with the port's nvcc flags into
`build/sass/` (the headers beside it on the include path). Needs the CUDA
toolkit (`nvcc`, `cuobjdump`); runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..ops import cuda_build

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path(cuda_build._nvcc()).with_name(name)
    if not path.exists():
        raise RuntimeError(f"{name} not found on PATH or beside nvcc")
    return str(path)


def binary(path: Path) -> Path:
    """A library as it is, or a `.cu` source compiled with the port's flags."""
    if path.suffix != ".cu":
        return path
    out = cuda_build.BUILD_DIR.parent / "sass" / (path.stem + ".so")
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(path.parent),
                    "-o", str(out), str(path)], check=True, capture_output=True)
    return out


def functions(text: str) -> dict:
    """{mangled name: [(address, instruction text, label or None)]}."""
    out, cur, label = {}, None, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            label = None
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), label))
            label = None
    return out


def loops(insns):
    """[(start, end, Counter of opcodes)] for each backward branch."""
    labels = {lab: addr for addr, _, lab in insns if lab}
    found = []
    for addr, text, _ in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target > addr:
            continue
        ops = collections.Counter()
        for a, t, _ in insns:
            if target <= a <= addr:
                words = t.split()
                ops[words[1] if words[0].startswith("@") else words[0]] += 1
        found.append((target, addr, ops))
    return found


def report(path: Path, function: str = "chain_kernel") -> dict:
    """{function: [{"start", "end", "instructions", "opcodes"}]} for the
    functions whose name holds `function`."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(binary(path))], check=True,
                          capture_output=True, text=True).stdout
    return {name: [dict(start=hex(s), end=hex(e), instructions=sum(ops.values()),
                        opcodes=dict(ops.most_common())) for s, e, ops in loops(insns)]
            for name, insns in functions(sass).items() if function in name}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", type=Path)
    ap.add_argument("--function", default="chain_kernel")
    args = ap.parse_args(argv)
    for name, found in report(args.path, args.function).items():
        print(name)
        for lp in found:
            print(f"  loop {lp['start']}-{lp['end']}: {lp['instructions']} instructions "
                  f"{lp['opcodes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
