"""the-decimator-jax: live DADA-ring to SIGPROC converter.

Equivalent of the reference ``the_decimator``
(``Signal/General/the_decimator.C:59-111``): attach to a live shared-memory
ring buffer, channelize/detect/decimate, and stream a SIGPROC filterbank
file in real time.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="the-decimator-jax",
        description="Live ring buffer -> SIGPROC filterbank converter",
    )
    p.add_argument("ring",
                   help="shared-memory ring: a POSIX name (/my_ring) or a "
                        "psrdada-style SysV hex key (e.g. 0xdada; the "
                        "reference's dada_hdu key, DADABuffer.C:175-208)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-F", "--nchan", type=int, default=128)
    p.add_argument("-t", "--tscrunch", type=int, default=1)
    p.add_argument("-b", "--nbits", type=int, default=8)
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from ..io.hostio import DadaReader, RingReader
    from ..models.load_to_fil import FilConfig, FilPipeline

    if args.ring.lower().startswith("0x"):
        ring = DadaReader(int(args.ring, 16))
    else:
        ring = RingReader(args.ring)
    nbuf = ring.buffer_samples()
    cfg = FilConfig(
        nchan=args.nchan,
        tscrunch_factor=args.tscrunch,
        nbits=args.nbits,
        min_block_samples=nbuf,
        block_parts=1,
    )
    pipe = FilPipeline(ring, cfg)
    if pipe.block_in_samples % nbuf:
        print(f"warning: block {pipe.block_in_samples} not a multiple of "
              f"ring buffer {nbuf}; the ring serves whole buffers only",
              file=sys.stderr)
    if not args.quiet:
        o = pipe.obs_out
        print(f"the-decimator-jax: {args.ring} -> {args.output} "
              f"nchan {o.nchan} nbit {o.nbit}", file=sys.stderr)
    try:
        pipe.run(args.output)
    except EOFError:
        pass
    ring.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
