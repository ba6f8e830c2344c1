"""CLI: python -m recnet_tpu_torch.cli.caption --ckpt <dir> --features f.hdf5

Port of ``recnet_tpu.cli.caption``: caption every video of an HDF5 feature
file with a ``Captioner`` on ``--device`` (``--mesh``: data parallel over
every visible card) and write "<vid>\\t\\t<caption>" lines, the
predictions.txt format of reference eval.py:158-160.
"""

from __future__ import annotations

import argparse

from recnet_tpu_torch.data.datasets import load_videos_hdf5
from recnet_tpu_torch.serving import Captioner


def main(argv=None):
    a = argparse.ArgumentParser()
    a.add_argument("--ckpt", type=str, required=True)
    a.add_argument("--features", type=str, required=True,
                   help="HDF5 of per-video feature arrays (frames, feat)")
    a.add_argument("--out", type=str, default="captions.txt")
    a.add_argument("--beam", type=int, default=0,
                   help="beam width (0 = greedy)")
    a.add_argument("--batch_size", type=int, default=1024)
    a.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    a.add_argument("--beam_length_margin", type=int, default=-1,
                   help="approximate beam cutoff: stop this many steps "
                        "after every beam candidate has a first <EOS> "
                        "(-1 = the exact full-length search)")
    a.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on (default cuda)")
    a.add_argument("--mesh", action="store_true",
                   help="data parallel over every visible card "
                        "(batch_size must divide by the card count)")
    args = a.parse_args(argv)

    margin = (None if args.beam_length_margin < 0
              else args.beam_length_margin)
    mesh = None
    if args.mesh:
        from recnet_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    captioner = Captioner.from_checkpoint(
        args.ckpt, dtype=args.dtype, batch_size=args.batch_size,
        beam_length_margin=margin, device=args.device, mesh=mesh)
    videos = load_videos_hdf5(args.features)
    vids = list(videos.keys())
    captions = captioner.caption(
        [videos[v] for v in vids],
        beam_width=args.beam if args.beam > 0 else None)
    with open(args.out, "w") as f:
        for vid, cap in zip(vids, captions):
            f.write(f"{vid}\t\t{cap}\n")
    print(f"Wrote {len(captions)} captions to {args.out}")


if __name__ == "__main__":
    main()
