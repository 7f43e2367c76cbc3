#!/usr/bin/env python
"""Bonsai demo (examples/bonsai/): raymarch the 256^3 CT volume."""

from common import finish, make_parser, maybe_cpu, orbit_events


def main():
    parser = make_parser("bonsai")
    args = parser.parse_args()
    maybe_cpu(args)
    from vokselis.engine.loop import run
    from vokselis.models.bonsai import BonsaiDemo

    camera = BonsaiDemo.default_camera(args.width / args.height)
    events = orbit_events(args.frames, args.width, args.height) if args.orbit else None
    ctx = run(
        BonsaiDemo,
        width=args.width,
        height=args.height,
        camera=camera,
        frames=args.frames,
        events=events,
    )
    finish(ctx, args)


if __name__ == "__main__":
    main()
