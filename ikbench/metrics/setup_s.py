"""setup_s (s): from the start of the process to the start of the window:
imports, the card's context, the program's build or load of its kernels,
the inputs made from the seed, and the warm-up of every shape the window
runs."""


def read(rec):
    return rec.get("setup_s")
