"""The kernel resource report of ``kernels/build.py`` on the CPU: the
``-Xptxas -v`` lines an H100 build writes to ``nvcc.log`` (captured below from
an sm_90a build of ``csrc/rbsor_lagged.cu`` and ``csrc/bfecc_sample.cu``) are
read back per kernel instance (registers, shared memory, spill bytes) and
turned into the warps each instance leaves resident on an SM.
"""

import pytest
import torch

from hnanosolver_tpu_torch.kernels import build

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2hn19rbsor_lagged_kernelILb1EEEvPKfS2_PKiS2_Pfiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN2hn19rbsor_lagged_kernelILb1EEEvPKfS2_PKiS2_Pfiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 14848 bytes smem
ptxas info    : Compile time = 71.098 ms
ptxas info    : Compiling entry function '_ZN2hn19rbsor_lagged_kernelILb0EEEvPKfS2_PKiS2_Pfiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN2hn19rbsor_lagged_kernelILb0EEEvPKfS2_PKiS2_Pfiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 14848 bytes smem
ptxas info    : Compile time = 32.489 ms
ptxas info    : Compiling entry function '_ZN2hn19bfecc_sample_kernelILi8ELi3ELb0EEEvPKfS2_PKiPfiff' for 'sm_90a'
ptxas info    : Function properties for _ZN2hn19bfecc_sample_kernelILi8ELi3ELb0EEEvPKfS2_PKiPfiff
    32 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes cumulative stack size, 108 bytes smem
ptxas info    : Compile time = 86.128 ms
ptxas info    : Compiling entry function '_ZN2hn19bfecc_sample_kernelILi8ELi3ELb1EEEvPKfS2_PKiPfiff' for 'sm_90a'
ptxas info    : Function properties for _ZN2hn19bfecc_sample_kernelILi8ELi3ELb1EEEvPKfS2_PKiPfiff
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size, 108 bytes smem
ptxas info    : Compile time = 64.953 ms
ptxas info    : Compiling entry function '_ZN2hn17bfecc_dual_kernelILi3ELi0ELb0EEEvPKfPKiS2_Pfiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN2hn17bfecc_dual_kernelILi3ELi0ELb0EEEvPKfPKiS2_Pfiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 43 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compile time = 32.478 ms
"""

# (instance, registers, smem, spill stores, spill loads, threads, resident warps)
EXPECTED = [
    # 80 regs: 2560 a warp, 25 warps of registers -> 6 blocks of 4 warps
    ("rbsor_lagged_kernel<true>", 80, 14848, 0, 0, 128, 24),
    # 64 regs: 2048 a warp, 32 warps -> 8 blocks of 4
    ("rbsor_lagged_kernel<false>", 64, 14848, 0, 0, 128, 32),
    ("bfecc_sample_kernel<8, 3, false>", 64, 108, 28, 28, 256, 32),
    ("bfecc_sample_kernel<8, 3, true>", 64, 108, 24, 24, 512, 32),
    # the nbr form's shape, 256 threads: 43 regs round up to 1536 a warp, 42
    # warps of registers -> 5 blocks of 8
    ("bfecc_dual_kernel<3, 0, false>", 43, 32, 0, 0, 256, 40),
]


def test_parse_ptxas_reads_every_instance():
    got = [(r.name, r.registers, r.shared, r.spill_stores, r.spill_loads, r.threads,
            r.resident_warps()) for r in build.parse_ptxas(PTXAS)]
    assert got == EXPECTED


@pytest.mark.parametrize("symbol,name", [
    ("_ZN2hn19rbsor_lagged_kernelILb0EEEvPKfS2_PKiS2_Pfiiff", "rbsor_lagged_kernel<false>"),
    ("_ZN2hn19bfecc_sample_kernelILi11ELi3ELb1EEEvPKfS2_PKiPfiff",
     "bfecc_sample_kernel<11, 3, true>"),
    ("_ZN2hn15residual_kernelEPKfS1_PKiPff", "residual_kernel"),
    ("hn_plain_c_symbol", "hn_plain_c_symbol"),
])
def test_demangle(symbol, name):
    assert build.demangle(symbol) == name


@pytest.mark.parametrize("regs,smem,threads,warps", [
    (32, 2048, 512, 64),      # the warp limit
    (255, 0, 256, 8),         # registers: 8192 a warp -> 8 warps, one block
    (16, 120_000, 128, 4),    # shared memory: one block of 120 KB (+1 KB) fits
    (16, 0, 32, 32),          # the limit of 32 blocks an SM
])
def test_resident_warps_limits(regs, smem, threads, warps):
    r = build.KernelResources("k", regs, smem, 0, 0, threads)
    assert r.resident_warps() == warps


def test_unlisted_kernel_has_no_occupancy():
    r = build.KernelResources("unknown_kernel", 32, 0, 0, 0, build.block_threads("unknown_kernel"))
    assert r.threads is None and r.resident_warps() is None
    assert "?" in r.line()


def test_require_aligned_rejects_an_offset_view():
    """B3's wrapper checks that p, div and mask start on 16 bytes (the
    kernel's float4 loads) before it launches."""
    base = torch.zeros(4 * 512 + 4)
    build.require_aligned((base[:2048], None), "x", 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        build.require_aligned((base[1:2049],), "x", 16)
