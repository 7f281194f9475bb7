"""Kernel names of the port in the device trace."""

import re

K2 = "resident_cg_kernel"
K1 = "cutband_apply"
# K2's one-band mode is its template's third argument, MODE_BAND = 2
K2_BAND = re.compile(r"resident_cg_kernel<[^,<>]+,\s*\w+,\s*2>")


def device_s(t, pred):
    return sum(d for name, _, d, _ in t.kernels if pred(name)) * 1e-6
