"""CPU tests of the benchmark: its arithmetic, its files and its checks at
tiny sizes. Run with ``python -m pytest portbench/tests``."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
