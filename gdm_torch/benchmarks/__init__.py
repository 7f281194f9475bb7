"""gdm's micro-benchmarks on the card.

``mxu_micro`` (gdm's benchmarks/mxu_micro.py: M1, the 2D Laplace's
stages alone, and M2, a transpose in fast memory) and
``stream_overlap_micro`` (gdm's benchmarks/stream_overlap_micro.py: M3,
M4 and M5, whether tile copies hide under compute), each a
hand-written CUDA kernel beside its plain torch twin, and ``timing``,
the device timers they and ``chip_smoke.py`` share.  Run on a card:

    python -m gdm_torch.benchmarks.mxu_micro [quick]
    python -m gdm_torch.benchmarks.stream_overlap_micro [N0 N1 tile_r nb nsplit modes...]
"""
