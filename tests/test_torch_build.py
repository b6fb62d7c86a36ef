"""The kernel build's cache key (paddle_tpu_torch/ops/cuda/build.py): a
library is named by a hash of its source, of every csrc/*.cuh header and
of the flags, so an edit to a shared header rebuilds every source. No
nvcc is needed: the tests only name libraries."""
import os

import pytest

from paddle_tpu_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "helpers.cuh"\n')
    (src / "helpers.cuh").write_text("// helpers\n")
    monkeypatch.setattr(build, "CSRC", str(src))
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    return src


@pytest.mark.parametrize("edit,rebuilt", [
    (None, False),
    (("helpers.cuh", "// helpers, edited\n"), True),
    (("kern.cu", '#include "helpers.cuh"\n// edited\n'), True),
    (("more.cuh", "// a new header\n"), True),
])
def test_library_name_follows_source_and_headers(csrc, edit, rebuilt):
    before = build.library_path("kern")
    assert os.path.dirname(before) == build.build_dir()
    assert os.path.basename(before).startswith("kern-")
    if edit is not None:
        (csrc / edit[0]).write_text(edit[1])
    assert (build.library_path("kern") != before) == rebuilt


@pytest.mark.parametrize("log", [None, "ptxas info    : Used 8 registers\n"])
def test_build_finds_a_library_already_built(csrc, log):
    """An unchanged source whose library exists is loaded as it is: no
    nvcc run; the log is the one kept beside the library, or empty when
    there is none."""
    path = build.library_path("kern")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    if log is not None:
        with open(f"{path}.log", "w") as f:
            f.write(log)
    assert build.build("kern") == (path, log or "")


def test_build_keeps_nvcc_output_beside_the_library(csrc, tmp_path,
                                                    monkeypatch):
    """nvcc's output is saved with the library, and a second build of the
    unchanged source returns it without running nvcc."""
    nvcc = tmp_path / "nvcc"
    # writes the file after -o and prints a ptxas line
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info    : Used 9 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build.shutil, "which", lambda _: str(nvcc))
    path, log = build.build("kern")
    assert os.path.exists(path) and "Used 9 registers" in log
    nvcc.unlink()
    assert build.build("kern") == (path, log)


def _chip_smoke():
    """chip_smoke.py at the repository's root, imported from its path (it
    imports only the standard library at the top)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# nvcc -Xptxas=-v output for five kernel instances of the sources
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b13dq_kernel_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b13dq_kernel_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_ifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_fwd_cu_2c13897917fwd_kernel_tf32x3ILi64EEEvPKfS2_S2_PfS3_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_fwd_cu_2c13897917fwd_kernel_tf32x3ILi64EEEvPKfS2_S2_PfS3_iifi
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_fwd_cu_2c13897914fwd_kernel_mmaILi64ELi2EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi' for 'sm_90a'
ptxas info    : Used 253 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b16dq_kernel_tf32x3ILi128EEEvPKfS2_S2_S2_S2_S2_Pfifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b16dq_kernel_tf32x3ILi128EEEvPKfS2_S2_S2_S2_S2_Pfifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b17dkv_kernel_tf32x3ILi32EEEvPKfS2_S2_S2_S2_S2_PfS3_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_bwd_cu_5e7a1c2b17dkv_kernel_tf32x3ILi32EEEvPKfS2_S2_S2_S2_S2_PfS3_ifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 428 bytes cmem[0]
"""


def test_ptxas_log_names_each_kernel_instance():
    """chip_smoke's build phase reads each instance's name, registers and
    spill line from nvcc's log; an instance whose log has no spill line
    gets an empty one (and so fails the zero-spill check), not the line of
    the instance before it."""
    assert _chip_smoke()._ptxas_kernels(PTXAS_LOG) == [
        ("dq_kernel_mma<64>", 168,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("fwd_kernel_tf32x3<64>", 255,
         "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"),
        ("fwd_kernel_mma<64, 2>", 253, ""),
        ("dq_kernel_tf32x3<128>", 232,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("dkv_kernel_tf32x3<32>", 128,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
    ]


@pytest.mark.parametrize("log,fails", [
    (PTXAS_LOG.split("ptxas info    : Compiling entry function '_ZN55_GLOBAL"
                     "__N__9cd0acc9_22_flash_attention_fwd_cu_2c13897917")[0],
     None),
    ("", "no ptxas log"),
    (PTXAS_LOG, "spill"),
])
def test_build_phase_gate_reads_every_log(monkeypatch, log, fails):
    """The build phase fails on a spill, and on a source whose library
    was found built with no log to read, rather than passing unchecked."""
    smoke = _chip_smoke()
    monkeypatch.setattr(build, "build", lambda name: ("lib.so", log))
    if fails is None:
        smoke.build_phase()
    else:
        with pytest.raises(AssertionError, match=fails):
            smoke.build_phase()
