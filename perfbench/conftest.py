import sys
from pathlib import Path

# the port, as the harness finds it (``harness.prepare_env``)
_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
