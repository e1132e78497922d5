"""Device milliseconds per batched control step of every kernel that is
not B1, B2 or B3 (by name): the PyTorch ops of the QP prologue, the FTOCP
assembly and the controller's elementwise work."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec["profiled_steps"]:
        return None
    return 1e3 * t["kernel_s"]["other"] / rec["profiled_steps"]
