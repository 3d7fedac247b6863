"""Import hygiene: what runs in a benchmark process loads neither JAX nor
the JAX package (top-level module names compared whole: the port's name
begins with the JAX package's), and the plain references load nothing of
the program."""

import subprocess
import sys

import pytest

from conftest import BENCH, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "mvae_tpu"}
PRINT_MODULES = (
    "import atexit\n"
    "atexit.register(lambda: print('MODULES', ' '.join(sorted({m.split('.')[0]"
    " for m in list(sys.modules)})), file=sys.stderr))")


def loaded(stderr):
    line = next(l for l in stderr.splitlines() if l.startswith("MODULES"))
    return set(line.split()[1:])


@pytest.mark.parametrize("workload", ["celeba.train.b4096",
                                      "celeba.score.k100",
                                      "celeba19.train.b2048"])
def test_cells_load_no_jax(checkout, workload):
    rc, line, err = run_cell(checkout, workload, patch=PRINT_MODULES)
    assert rc == 0, err[-3000:]
    mods = loaded(err)
    assert "mvae_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_harness_refuses_a_loaded_jax_package(checkout, tmp_path):
    """A run in whose process the JAX package's name is loaded prints no
    result and exits with another code than 0."""
    fake = tmp_path / "fake"
    (fake / "mvae_tpu").mkdir(parents=True)
    (fake / "mvae_tpu" / "__init__.py").write_text("")
    rc, line, err = run_cell(
        checkout, "celeba.score.k100",
        patch=f"sys.path.insert(0, {str(fake)!r}); import mvae_tpu")
    assert rc != 0 and line is None
    assert "mvae_tpu" in err


def test_references_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.common, reference.celeba, reference.celeba19\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    assert "torch" in out
    assert not set(out) & (FORBIDDEN | {"mvae_tpu_torch", "harness"})
