from .piston import define_piston_problem, throughput_profile

__all__ = ["define_piston_problem", "throughput_profile"]
