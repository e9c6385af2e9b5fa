"""The benchmark's own count of each kernel's work and of each model's FLOPs.

``<kernel>.py`` gives, as functions of a call's shapes, the operations and
the bytes one call needs (each input read once, each output written once)
and the names its launches carry in a device trace; ``models.py`` the
model FLOPs of both models from the config's widths; ``peaks.py`` the
card's published peaks. These are frozen copies: they import nothing of
the program, which later changes may not alter the yardstick through.
"""
