from .sweep import solve_fom_batch

__all__ = ["solve_fom_batch"]
