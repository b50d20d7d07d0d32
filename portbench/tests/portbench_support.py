"""What the benchmark's tests share besides the fixtures of conftest.py."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the j0005 configuration at 32x32 with a 16x16 PSF star: the CPU tests' size
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny.json")
# the tests' limits, between the port's plain float32 path's readings at
# the tiny size and the faults'
CHECK_LIMITS = {"lnp_gap": {"max": 1e-4}, "image_gap": {"max": 1e-4},
                "unmoved_walkers": {"max": 0.25}, "unmoved_targets": {"max": 0.25}}
# 16 retained steps of the driver: time for each sound walker to move
TINY_SIZES = {"j0005.single": {"iterations": 16},
              "j0005.survey": {"targets": 3, "burn": 4, "iterations": 4}}
