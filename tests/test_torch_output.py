"""``PMMHOutput``'s summary, print format and NA diagnostics, the mirror
of ``tests/test_output.py``, on the JAX test's output and beside the JAX
class's (``tests/test_torch_diagnostics.py`` compares the whole printed
text and data frames).
"""

import numpy as np

from bayesssm_tpu.output import PMMHOutput as JPMMHOutput
from bayesssm_tpu_torch.output import PMMHOutput


def make_output(cls=PMMHOutput):
    rng = np.random.default_rng(0)
    return cls(
        theta_chain={
            "param1": rng.normal(size=(2, 100)),
            "param2": rng.normal(size=(2, 100)),
        },
        diagnostics={
            "ess": {"param1": 200.7, "param2": 190.2},
            "rhat": {"param1": 1.01, "param2": 1.0},
        },
    )


def test_summary_fields():
    out = make_output()
    summ = out.summary()
    assert set(summ) == {"param1", "param2"}
    row = summ["param1"]
    assert set(row) == {"mean", "sd", "median", "2.5%", "97.5%", "ESS",
                        "Rhat"}
    pooled = out.pooled("param1")
    np.testing.assert_array_equal(pooled,
                                  make_output(JPMMHOutput).pooled("param1"))
    np.testing.assert_allclose(row["mean"], pooled.mean())
    np.testing.assert_allclose(row["sd"], pooled.std(ddof=1))
    np.testing.assert_allclose(row["median"], np.median(pooled))
    np.testing.assert_allclose(row["2.5%"], np.quantile(pooled, 0.025))
    np.testing.assert_allclose(row["97.5%"], np.quantile(pooled, 0.975))
    assert row["ESS"] == 200.7


def test_print_format(capsys):
    out = make_output()
    assert out.print() is out
    text = capsys.readouterr().out
    assert "PMMH Results Summary:" in text
    # floor(ESS) and a 3-decimal Rhat (print.R:50-51).
    assert "1.010" in text
    lines = text.strip().splitlines()
    assert lines[1].split() == [
        "Parameter", "Mean", "SD", "Median", "2.5%", "97.5%", "ESS", "Rhat",
    ]
    assert lines[2].split()[0] == "param1" and lines[2].split()[-2] == "200"
    assert text == str(make_output(JPMMHOutput)) + "\n"


def test_nan_diagnostics_na():
    out = make_output()
    out.diagnostics["ess"]["param1"] = float("nan")
    text = str(out)
    assert "NA" in text
    want = make_output(JPMMHOutput)
    want.diagnostics["ess"]["param1"] = float("nan")
    assert text == str(want)
