"""Compare the SASS of two source trees' kernel objects, function by function.

    python -m vch_tpu_torch.probes.sass_diff OTHER_ROOT [--only SRC ...]
        [--out DIR]

For every object that both this tree's and OTHER_ROOT's `ops/_build.py`
list in SOURCES with the same source and flags (`--only`: of these sources
alone), compiles that tree's source to a cubin for sm_90a with its own
NVCC_FLAGS, disassembles each with cuobjdump -sass and compares the two
listings function by function. OTHER_ROOT is the root of a checkout (say,
the parent commit unpacked with `git archive`). Prints one JSON object:
per object, the functions whose SASS is identical, those that differ (each
with its count of differing instruction lines and the first few of them,
addresses and encodings left out), and those found in one tree only; the
two listings of a function that differs are written under DIR (default:
the kernels' build directory, vch_tpu_torch/_build/sass_diff). Needs the
CUDA toolkit (nvcc, cuobjdump), no card; the compiles run in parallel.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
from pathlib import Path

from vch_tpu_torch.ops import _build

_FUNC = re.compile(r"^\s*Function : (\S+)\s*$", re.M)


def _other_build(root: Path):
    """The `ops/_build.py` module of the tree at `root`."""
    path = root / "vch_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("_other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def functions(sass: str) -> dict:
    """A cuobjdump -sass listing split into {function name: its text}."""
    heads = list(_FUNC.finditer(sass))
    return {m.group(1): sass[m.end():nxt.start() if nxt else len(sass)]
            for m, nxt in zip(heads, heads[1:] + [None])}


def instructions(text: str) -> list:
    """The instruction lines of a function's listing without their
    addresses and encodings."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", line).strip()
        if line and not line.startswith(("/*", ".")):
            out.append(" ".join(line.split()))
    return out


def _cuobjdump(nvcc: str) -> str:
    tool = Path(nvcc).with_name("cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def compare(other_root, only=(), out_dir=_build.BUILD_DIR / "sass_diff"):
    """The report `main` prints (see the module's docstring)."""
    other = _other_build(Path(other_root).resolve())
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objects = [(src, flags) for src, objs in _build.SOURCES.items()
               for flags in objs
               if (not only or src in only)
               and flags in other.SOURCES.get(src, ())]
    trees = {"this": _build, "other": other}
    jobs = {}
    for src, flags in objects:
        tag = "_".join((Path(src).stem,) + tuple(
            f.strip("-").replace("=", "") for f in flags))
        for which, mod in trees.items():
            cubin = out / f"{tag}.{which}.cubin"
            cmd = [nvcc, *mod.NVCC_FLAGS, *flags, "-cubin", "-o", str(cubin),
                   str(mod.SRC_DIR / src)]
            jobs[(tag, which)] = (cubin, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    dump = _cuobjdump(nvcc)
    result = {}
    for (tag, which), (cubin, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} ({which}): nvcc exit "
                               f"{proc.returncode}:\n{log}")
        sass = subprocess.run([dump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        cubin.unlink()
        result.setdefault(tag, {})[which] = functions(sass)
    report = {}
    for tag, both in result.items():
        a, b = both["this"], both["other"]
        differ = {}
        for f in sorted(f for f in a if f in b and a[f] != b[f]):
            ia, ib = instructions(a[f]), instructions(b[f])
            pairs = [(x, y) for x, y in zip(ia, ib) if x != y]
            differ[f] = dict(lines=(len(ia), len(ib)),
                             differing=len(pairs) + abs(len(ia) - len(ib)),
                             first=pairs[:8])
            for which, text in (("this", a[f]), ("other", b[f])):
                (out / f"{tag}.{f[:80]}.{which}.sass").write_text(text)
        report[tag] = dict(
            identical=sorted(f for f in a if f in b and a[f] == b[f]),
            differ=differ, this_only=sorted(set(a) - set(b)),
            other_only=sorted(set(b) - set(a)))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--only", nargs="*", default=())
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "sass_diff"))
    a = ap.parse_args(argv)
    print(json.dumps(compare(a.other_root, tuple(a.only), a.out)))


if __name__ == "__main__":
    main()
