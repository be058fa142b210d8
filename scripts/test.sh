#!/usr/bin/env bash
# Run the test suite on the virtual 8-device CPU mesh (tests/conftest.py).
set -euo pipefail
cd "$(dirname "$0")/.."
exec env JAX_PLATFORMS=cpu python -m pytest tests/ "$@"
