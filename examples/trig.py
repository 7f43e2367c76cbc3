#!/usr/bin/env python
"""Trig demo (examples/trig.rs): camera-transformed triangle."""

from common import finish, make_parser, maybe_cpu, orbit_events


def main():
    args = make_parser("trig").parse_args()
    maybe_cpu(args)
    from vokselis.engine.loop import run
    from vokselis.models.trig import TrigDemo

    events = orbit_events(args.frames, args.width, args.height) if args.orbit else None
    ctx = run(
        TrigDemo,
        width=args.width,
        height=args.height,
        camera=None,  # default pose, like run::<BasicTrig>(.., None)
        frames=args.frames,
        events=events,
    )
    finish(ctx, args)


if __name__ == "__main__":
    main()
