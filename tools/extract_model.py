#!/usr/bin/env python3
"""Extract a lumped rigid-body model spec (qrm-v1 JSON) from a URDF.

Thin CLI around quadrupedwholebodycontroller.models.urdf.parse_urdf.
Default orderings target the ANYmal-D reference
(/root/reference/urdf/anymal.urdf): actuated joints in the reference
controller's model order (src/whole_body_controller.cpp:234) and foot frames
in the jacobian stacking order (src/whole_body_controller.cpp:327-341).

Usage: python tools/extract_model.py <urdf> <out.json>
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from quadrupedwholebodycontroller.models.urdf import parse_urdf  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("urdf")
    ap.add_argument("out")
    ap.add_argument("--name", default="anymal_d")
    ap.add_argument(
        "--joint-order",
        default="LH_HAA,LH_HFE,LH_KFE,LF_HAA,LF_HFE,LF_KFE,"
        "RF_HAA,RF_HFE,RF_KFE,RH_HAA,RH_HFE,RH_KFE",
    )
    ap.add_argument("--frames", default="LH_FOOT,LF_FOOT,RF_FOOT,RH_FOOT")
    args = ap.parse_args()

    spec = parse_urdf(
        args.urdf, args.joint_order.split(","), args.frames.split(","), name=args.name
    )
    with open(args.out, "w") as f:
        json.dump(spec, f, indent=1)
    print(f"bodies={len(spec['bodies'])} total_mass={spec['total_mass']:.6f}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
