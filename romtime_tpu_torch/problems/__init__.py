from .piston import define_piston_problem

__all__ = ["define_piston_problem"]
