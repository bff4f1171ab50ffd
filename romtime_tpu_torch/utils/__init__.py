from .numeric import compute_rom_difference, time_average

__all__ = ["compute_rom_difference", "time_average"]
