"""What the compiler made of the CUDA kernels: registers, spills, shared
memory and f64 tensor-core instructions per kernel.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 -m mlmc_tpu_torch.tool.kernel_sass

Builds every ``mlmc_tpu_torch/csrc/*.cu`` (``ops/_build.build_all``), then
reads each library with ``cuobjdump``: ``-res-usage`` gives each kernel's
registers, stack frame, local memory and static shared memory, and
``-sass`` its instructions, of which the ``DMMA`` lines (f64
``mma.sync``), ``DFMA`` lines (f64 fused multiply-adds), ``LDL``/``STL``
lines (local-memory loads and stores: register spills and stack traffic),
the f32-pipe instructions (``F32``: f32 arithmetic, compares and
conversions and the ``MUFU`` special functions) and the integer-pipe
instructions (``INT``: integer multiply-adds, adds, logic, shifts and
compares) are counted. The counts are static: a branch that never runs
counts as much as one that always runs. One such branch is set apart: the
slow argument reduction of the accurate ``sinf``/``cosf`` (Payne-Hanek,
for |x| >= 105615, with a local array), which the kernels' Box-Muller
angles (below 2 pi) never take. It is found as the code that a forward
branch on a compare with 105615 skips, and the counts leave it out;
``LDL_ALL``/``STL_ALL`` count every local load and store, its own
included. ``LOOP_INT``/``LOOP_F32`` count the integer and f32
instructions on the path through one turn of the function's outermost
loop that issues the fewest of them (a branch that this turn need not
take, such as kernel B's slot-by-slot stores of a range's head and tail
quads, is left out): for kernel B, one Philox call and four normals.
``ROLES`` lists the register counts that a warp-specialised kernel's
``setmaxnreg`` sets per thread (``USETMAXREG`` in SASS), highest first:
kernel A's consumers and producers; ``reg`` is the count at launch.
"""
import collections
import heapq
import os
import re
import subprocess

from mlmc_tpu_torch.ops import _build

_RES = re.compile(r"Function ([^:\s]+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)")
_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@(!?)(U?P[T0-9]+)\s+)?"
                    r"([A-Z][A-Z0-9_]*)[A-Z0-9_.]*\s*([^;]*);")
#: opcodes issued to the f32 pipes
F32_OPS = frozenset(("FADD", "FMUL", "FFMA", "FSETP", "FSET", "FSEL", "FMNMX",
                     "FRND", "FCHK", "FSWZADD", "MUFU", "I2F", "I2FP", "F2I", "F2F",
                     "F2FP"))
#: opcodes issued to the integer pipes (IMAD to the FMA pipe's integer half)
INT_OPS = frozenset(("IMAD", "IMUL", "IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF",
                     "SHL", "SHR", "LEA", "ISETP", "IMNMX", "VIMNMX", "SEL", "PRMT",
                     "IABS", "POPC", "FLO", "BREV", "BMSK", "SGXT"))
_COUNTED = ("DMMA", "DFMA", "LDL", "STL", "LDL_ALL", "STL_ALL", "F32", "INT",
            "LOOP_F32", "LOOP_INT", "ROLES")
_TRIG_SLOW = "105615"  # the accurate sinf/cosf take their slow path from here
_IMMEDIATE = re.compile(r"(0x[0-9a-f]+|\b\d+)\s*$")


def _branch_target(op, args):
    target = re.search(r"(0x[0-9a-f]+)\s*$", args) if op == "BRA" else None
    return None if target is None else int(target.group(1), 16)


def _loop_turn(instrs, in_slow_path):
    """(integer-pipe, f32-pipe) instructions on the path through one turn
    of the function's outermost loop that issues the fewest of the two:
    from the target of its backward branch to that branch, following
    fall-through and branch edges (a predicated branch has both), through
    no trig slow path and no call (the f32 square root's and division's
    special-case subroutines). (0, 0) where no such path is found."""
    back = [(target, i) for i, (addr, _, _, op, args) in enumerate(instrs)
            for target in [_branch_target(op, args)]
            if target is not None and target < addr and not in_slow_path(addr)]
    if not back:
        return 0, 0
    head, last = max(back, key=lambda b: instrs[b[1]][0] - b[0])
    index = {addr: i for i, (addr, *_) in enumerate(instrs)}
    first = index[head]

    def weight(i):
        op = instrs[i][3]
        return (op in INT_OPS) + (op in F32_OPS), op in INT_OPS, op in F32_OPS

    best = {}
    todo = [(weight(first), first)]
    while todo:
        (cost, n_int, n_f32), i = heapq.heappop(todo)
        if i in best:
            continue
        best[i] = (cost, n_int, n_f32)
        addr, _, pred, op, args = instrs[i]
        if i == last:
            return n_int, n_f32
        target = _branch_target(op, args)
        nexts = []
        if target is None or pred not in ("", None, "PT") or "," in args:
            nexts.append(i + 1)  # falls through (a branch only if predicated)
        if target is not None and target in index and head < target <= instrs[last][0]:
            nexts.append(index[target])
        if op in ("EXIT", "RET", "CALL"):
            nexts = []  # leaves the turn, or calls a special-case subroutine
        for j in nexts:
            if j < len(instrs) and j not in best and not in_slow_path(instrs[j][0]):
                w = weight(j)
                heapq.heappush(todo, ((cost + w[0], n_int + w[1], n_f32 + w[2]), j))
    return 0, 0


def _count(instrs):
    """Counts of one function's instructions [(address, negated, predicate,
    opcode, operands)]. The code that a forward ``@!P BRA`` skips, where P
    was last set by a compare with 105615, is the trig slow path: only its
    local loads and stores are counted, in LDL_ALL and STL_ALL."""
    counts = collections.Counter()
    set_by = {}
    skipped = []
    for addr, neg, pred, op, args in instrs:
        if op.endswith("SETP"):
            set_by[args.split(",")[0].strip()] = args
        target = _branch_target(op, args)
        if target is not None and neg == "!" and _TRIG_SLOW in set_by.get(pred, "") \
                and target > addr:
            skipped.append((addr, target))

    def in_slow_path(addr):
        return any(lo < addr < hi for lo, hi in skipped)

    roles = set()
    for addr, neg, pred, op, args in instrs:
        if op == "USETMAXREG":
            m = _IMMEDIATE.search(args)
            if m:
                roles.add(int(m.group(1), 0))
        counts["LDL_ALL"] += op == "LDL"
        counts["STL_ALL"] += op == "STL"
        if in_slow_path(addr):
            continue
        counts[op] += 1
        counts["F32"] += op in F32_OPS
        counts["INT"] += op in INT_OPS
    counts["LOOP_INT"], counts["LOOP_F32"] = _loop_turn(instrs, in_slow_path)
    counts["ROLES"] = sorted(roles, reverse=True)
    return counts


def _tool(name):
    path = os.path.join(os.path.dirname(_build.find_nvcc()), name)
    return path if os.path.isfile(path) else name


def _demangle(names):
    """Readable names through cu++filt (mangled ones where it is missing)."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return dict(zip(names, names))
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else dict(zip(names, names))


def report(lib_path):
    """{mangled kernel name: dict(reg, stack, shared, local, DMMA, DFMA,
    LDL, STL, LDL_ALL, STL_ALL, F32, INT, LOOP_F32, LOOP_INT, ROLES)}."""
    cuobjdump = _tool("cuobjdump")
    res = subprocess.run([cuobjdump, "-res-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300, check=True)
    kernels = {}
    for m in _RES.finditer(res.stdout):
        kernels[m.group(1)] = dict(reg=int(m.group(2)), stack=int(m.group(3)),
                                   shared=int(m.group(4)), local=int(m.group(5)))
    if not kernels:
        raise RuntimeError("no kernel in cuobjdump -res-usage output:\n"
                           + res.stdout[:4000])
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300, check=True)
    counts = count_sass(sass.stdout)
    for name, info in kernels.items():
        info.update({op: counts.get(name, {}).get(op, [] if op == "ROLES" else 0)
                     for op in _COUNTED})
    return kernels


def count_sass(text):
    """{function name: instruction counts} of a ``cuobjdump -sass`` listing."""
    instrs = collections.defaultdict(list)
    current = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            current = m.group(1)
            continue
        m = _INSTR.search(line) if current is not None else None
        if m:
            instrs[current].append((int(m.group(1), 16),) + m.group(2, 3, 4, 5))
    return {name: _count(listing) for name, listing in instrs.items()}


def _short_name(mangled):
    """Kernel A's, B's, C's and D's names as the docs write them ("A NB=4":
    kernel A with four moment blocks), or None (the reductions)."""
    m = re.search(r"synth_mlmc_kernelILi(\d)E", mangled)
    if m:
        return "A NB=" + m.group(1)
    m = re.search(r"samples_gram_kernelILi(\d)E([df])", mangled)
    if m:
        return "%s NB=%s" % ({"f": "C", "d": "D"}[m.group(2)], m.group(1))
    return "B" if "normals_dump_kernel" in mangled else None


def summary(lib_path):
    """{short name: counts} of kernels A-D in the library at ``lib_path``:
    the keys of ``report`` but shared memory, local size, DMMA and DFMA."""
    keep = ("reg", "stack") + _COUNTED[2:]
    out = {}
    for mangled, info in report(lib_path).items():
        short = _short_name(mangled)
        if short is not None:
            out[short] = {k: info[k] for k in keep}
    return dict(sorted(out.items()))


def main():
    for name, path in sorted(_build.build_all().items()):
        kernels = report(path)
        readable = _demangle(list(kernels))
        print("%s.cu (%s):" % (name, path.name))
        for mangled, info in sorted(kernels.items(), key=lambda kv: readable[kv[0]]):
            print("  %-60s REG %3d  STACK %4d  SHARED %6d  DMMA %4d  DFMA %5d  "
                  "LDL %3d  STL %3d (all %3d %3d)  F32 %5d  INT %5d  loop F32 %4d "
                  "INT %4d  roles %s"
                  % (readable[mangled][:60], info["reg"], info["stack"], info["shared"],
                     info["DMMA"], info["DFMA"], info["LDL"], info["STL"],
                     info["LDL_ALL"], info["STL_ALL"], info["F32"], info["INT"],
                     info["LOOP_F32"], info["LOOP_INT"],
                     "/".join(map(str, info["ROLES"])) or "-"))


if __name__ == "__main__":
    main()
