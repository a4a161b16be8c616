"""Version info; VERSION_NAME tags benchmark result records, as the JAX
package's version.py does (reference: src/common/common.h:47)."""

__version__ = "0.1.0"

VERSION_NAME = "cuda-latest"
