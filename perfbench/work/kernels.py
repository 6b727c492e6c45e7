"""Operations and bytes of one call of the port's kernel wrappers, copied
from ``repro_torch/kernels/record.py`` (``qmm_work``, ``fq_work``), and the
names of each family's kernels as the device trace shows them, copied from
the ``__global__`` functions of its ``.cu`` file.

Each input is read once and the output written once; FLOPs are the dots'
``2 * M * K * N``; the element-wise fake-quant forward has none.
"""
from typing import Optional


def qmm_work(e: int, m: int, k: int, n: int, bits: int, g: int) -> tuple[float, float]:
    """x (E, M, K) f32 @ codes (E, K*bits/8, N) + scales (E, G, N) f32 ->
    (E, M, N) f32: (flops, bytes)."""
    weight = e * (k * n * bits // 8 + g * n * 4)
    return 2.0 * e * m * k * n, float(weight + e * (m * k * 4 + m * n * 4))


def fq_work(k: int, n: int, s_rows: int) -> tuple[float, float]:
    """w and v (K, N) f32 and the (s_rows, N) scale read once, (K, N) f32
    written once: (flops, bytes)."""
    return 0.0, 4.0 * (3 * k * n + s_rows * n)


# family: (the wrapper's work function in record.py, the dims it passes after
# the kernel's name or none, this file's formula, the kernels of the .cu file)
FAMILIES = {
    "qmm": ("qmm_work", 1, qmm_work,
            ("qgemv_grouped_kernel", "qgemv_tc_kernel", "qmatmul_grouped_kernel",
             "qmatmul_kernel", "qmm_short_kernel", "qmm_wide_kernel")),
    "fakequant": ("fq_work", 0, fq_work, ("fq_scalar_kernel", "fq_vec4_kernel")),
}


def call_work(family: str, work_name: str, dims: tuple) -> Optional[tuple[float, float]]:
    """(flops, bytes) of one wrapper call, from the dims the wrapper hands
    ``record.call`` with its work function; None for another family's call."""
    name, skip, formula, _kernels = FAMILIES[family]
    return formula(*dims[skip:]) if work_name == name else None
