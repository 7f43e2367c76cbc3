#!/usr/bin/env python
"""Xor demo (examples/xor/): compute raymarch of the procedural volume."""

from common import finish, make_parser, maybe_cpu, orbit_events


def main():
    parser = make_parser("xor")
    args = parser.parse_args()
    maybe_cpu(args)
    from vokselis.engine.loop import run
    from vokselis.models.xor import XorDemo

    camera = XorDemo.default_camera(args.width / args.height)

    def events():
        if args.orbit:
            yield from orbit_events(args.frames, args.width, args.height)

    ctx = run(
        XorDemo,
        width=args.width,
        height=args.height,
        camera=camera,
        frames=args.frames,
        events=events(),
        watch=args.watch,
    )
    finish(ctx, args)


if __name__ == "__main__":
    main()
