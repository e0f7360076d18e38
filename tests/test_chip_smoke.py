"""chip_smoke.py refuses to run without a GPU and prints no result."""

import pytest


def test_chip_smoke_refuses_the_cpu(capsys):
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out
