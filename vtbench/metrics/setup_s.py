"""setup_s: seconds from process start to the window's first iteration (build, scene, warm-up)."""


def read(rec):
    return rec.setup_s
