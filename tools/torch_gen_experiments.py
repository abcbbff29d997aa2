"""Render the port's dry-run tables (``repro_torch.roofline.tables``) from
its JSON artifacts into marked blocks of a markdown file: one H100
(``single``) and, as the reference renders its two meshes, the (16, 16)
``pod`` and (2, 16, 16) ``multi`` meshes' cells (per device).

    PYTHONPATH=src python tools/torch_gen_experiments.py [--dir experiments/torch_dryrun] [--out FILE]

Without ``--out`` the tables are printed and nothing is written. With it,
each block between ``<!-- BEGIN TORCH_<KEY> -->`` and ``<!-- END
TORCH_<KEY> -->`` in FILE is replaced, and a block whose markers are
missing is appended. Only the ``TORCH_`` blocks are touched, so the
reference's own blocks (``tools/gen_experiments.py``'s, in
``EXPERIMENTS.md``) stay as they are.
"""
import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
from repro_torch.roofline.tables import (dryrun_md, h100_md,  # noqa: E402
                                         load_cells, roofline_md)


MESHES = ("single", "pod", "multi")


def render(by_mesh):
    """The blocks of each mesh's cells (``by_mesh``: mesh -> cells)."""
    single = by_mesh["single"]
    blocks = {"TORCH_H100_SINGLE": h100_md(single),
              "TORCH_ROOFLINE_SINGLE": roofline_md(single),
              "TORCH_DRYRUN_SINGLE": dryrun_md(single)}
    for mesh in MESHES[1:]:
        blocks[f"TORCH_H100_{mesh.upper()}"] = h100_md(by_mesh[mesh])
        blocks[f"TORCH_DRYRUN_{mesh.upper()}"] = dryrun_md(by_mesh[mesh])
    return blocks


def write_blocks(text: str, blocks) -> str:
    for key, content in blocks.items():
        begin, end = f"<!-- BEGIN {key} -->", f"<!-- END {key} -->"
        block = begin + "\n" + content + "\n" + end
        if begin in text and end in text:
            text = re.sub(re.escape(begin) + r".*?" + re.escape(end),
                          lambda _: block, text, flags=re.S)
        else:
            text = text.rstrip("\n") + ("\n\n" if text else "") + block + "\n"
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--dir", default="experiments/torch_dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    by_mesh = {m: load_cells(args.dir, mesh=m, tag=args.tag) for m in MESHES}
    blocks = render(by_mesh)
    if not args.out:
        for key, content in blocks.items():
            print(f"## {key}\n\n{content}\n")
    else:
        text = open(args.out).read() if os.path.exists(args.out) else ""
        with open(args.out, "w") as f:
            f.write(write_blocks(text, blocks))
    cells = [d for m in MESHES for d in by_mesh[m]]
    counts = {s: sum(1 for d in cells if (d["status"] if d["status"] in
                                          ("ok", "skip") else "fail") == s)
              for s in ("ok", "skip", "fail")}
    print(f"[gen] cells ok={counts['ok']} skip={counts['skip']} "
          f"fail={counts['fail']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
