"""Build the port's CUDA sources for the CPU warp emulator (emu_cuda.h).

Every inline-asm statement of a source is rewritten into the emulator call
of the same instruction (an asm the rewriter does not know raises), each
kernel launch into emu_launch, and the dynamic shared memory and every
static __shared__ array into the running block's own copy (emu_dyn_smem,
EMU_SHARED).  The result compiles with g++ into a shared library with the
sources' C interface.
Used by tests/test_torch_*_emulated.py.
"""

import re
import shutil
import subprocess
from pathlib import Path

EMU = Path(__file__).resolve().parent
CSRC = EMU.parents[1] / "src" / "repro_torch" / "csrc"


def _close_paren(s, i):
    """Index past the ')' that closes s[i] == '('."""
    depth = 0
    for j in range(i, len(s)):
        depth += {"(": 1, ")": -1}.get(s[j], 0)
        if depth == 0:
            return j + 1
    raise ValueError("unbalanced parentheses")


def _operands(body):
    """[(constraint, expression)] of an asm statement's operands."""
    out = []
    for m in re.finditer(r'"([=+]?[a-z])"\(', body):
        out.append((m.group(1), body[m.end():_close_paren(body, m.end() - 1) - 1]))
    return out


def rewrite_asm(s):
    out, i = [], 0
    for m in re.finditer(r"\basm(\s+volatile)?\(", s):
        end = _close_paren(s, m.end() - 1)
        body = s[m.end():end - 1]
        text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', body.split(":")[0]))
        ops = [e.strip() for _, e in _operands(body)]
        if text.startswith(("cp.async.commit_group", "cp.async.wait_group")):
            rep = "(void)0;"      # the emulated copies are synchronous
        elif text.startswith("cp.async.cg.shared.global"):
            dst = re.fullmatch(r"smem_u32\((.*)\)", ops[0], re.S).group(1)
            rep = f"emu_cp_async16({dst}, {ops[1]}, {ops[2]});"
        elif text.startswith("atom.add.acq_rel.gpu.s32"):
            rep = f"{ops[0]} = atomicAdd({ops[1]}, 1);"
        elif text.startswith("barrier.cluster.arrive"):
            rep = "emu_cluster_arrive();"
        elif text.startswith("barrier.cluster.wait"):
            rep = "emu_cluster_wait();"
        elif text.startswith("mapa.u64"):
            rep = f"{ops[0]} = (uint64_t)emu_mapa({ops[1]}, {ops[2]});"
        elif text.startswith("mma.sync.aligned.m16n8k8.row.col.f32.tf32"):
            rep = f"emu_mma_tf32({ops[0][:-3]}, {ops[4][:-3]}, {ops[8][:-3]});"
        elif text.startswith("mma.sync.aligned.m16n8k16.row.col.f32.bf16"):
            rep = f"emu_mma_bf16({ops[0][:-3]}, {ops[4][:-3]}, {ops[8][:-3]});"
        else:
            raise ValueError(f"no emulation for asm {text!r}")
        out += [s[i:m.start()], rep]
        i = s.index(";", end) + 1
    return "".join(out + [s[i:]])


def rewrite(s):
    s = rewrite_asm(s)
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = emu_dyn_smem();")
    # a static __shared__ array or scalar: the block's own copy
    s = re.sub(r"\b__shared__\s+(?:__align__\(\d+\)\s+)?"
               r"([\w:]+(?:<[^<>;]*>)?)\s+(\w+)((?:\[[^\]]*\])*)\s*;",
               r"EMU_SHARED(\2, \1\3);", s)
    s = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^>]*)>>>\((.*?)\);",
               r"emu_launch(\2, [=] { \1(\3); });", s, flags=re.S)
    assert "<<<" not in s and not re.search(r"\b(asm|__shared__)\b", s)
    return s


def build(out_dir, stems, defines=None, name="emu"):
    """Compile csrc/<stem>.cu for each stem (each with its -D defines,
    {stem: [...]}) into out_dir/lib<name>.so; return its path."""
    gxx = shutil.which("g++")
    out_dir = Path(out_dir)
    for f in EMU.glob("*.h"):
        shutil.copy(f, out_dir / f.name)
    for f in CSRC.glob("*.cuh"):
        (out_dir / f.name).write_text(rewrite(f.read_text()))
    flags = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-I", str(out_dir),
             "-include", "cuda_runtime.h", "-Wno-unknown-pragmas"]
    objs, procs = [], []
    for stem in stems:
        src = out_dir / f"{stem}.cpp"
        src.write_text(rewrite((CSRC / f"{stem}.cu").read_text()))
        obj = out_dir / f"{stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [gxx, *flags, *(defines or {}).get(stem, []), "-c", str(src),
             "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out[-4000:]
    so = out_dir / f"lib{name}.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                    *map(str, objs)], check=True)
    return so
