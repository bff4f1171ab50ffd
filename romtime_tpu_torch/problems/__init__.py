from .piston import (
    JOINT_CENTER_MU,
    define_piston_problem,
    joint_fleet,
    joint_profile,
    piston_profile,
    throughput_profile,
)

__all__ = ["JOINT_CENTER_MU", "define_piston_problem", "joint_fleet",
           "joint_profile", "piston_profile", "throughput_profile"]
