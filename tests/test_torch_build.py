"""The port's CUDA build helpers that run without a card or a compiler."""
from repro_torch import _cuda_build

# the shape of an `nvcc -Xptxas -v` log for one source with two entries
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi256EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi256EEvPf
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_ptxas_summary_reads_each_entry():
    got = _cuda_build.ptxas_summary(PTXAS_LOG)
    assert got == {
        "_Z6kernelILi64EEvPf": dict(registers=90, stack_bytes=0,
                                     spill_store_bytes=0,
                                     spill_load_bytes=0),
        "_Z6kernelILi256EEvPf": dict(registers=168, stack_bytes=16,
                                      spill_store_bytes=8,
                                      spill_load_bytes=12),
    }


def test_ptxas_summary_of_an_empty_log_is_empty():
    assert _cuda_build.ptxas_summary("") == {}


def test_every_source_has_flags_and_a_library_path():
    for name in _cuda_build.SOURCES:
        path = _cuda_build.library_path(name)
        assert path.parent == _cuda_build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert "-Xptxas" in _cuda_build._nvcc_command(name, path)
