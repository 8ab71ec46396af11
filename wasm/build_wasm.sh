#!/usr/bin/env bash
# Build libcrackle.wasm + JS glue with emscripten (reference parity:
# wasm/build_wasm.sh there). Requires an emsdk environment (em++ on
# PATH); the CI image used for wheels has one, this repo's dev
# container does not — tests/test_wasm_shim.py exercises the exact
# same shim natively under g++ instead.
set -euo pipefail
cd "$(dirname "$0")"

em++ -O3 -std=c++17 \
  -s WASM=1 \
  -s ALLOW_MEMORY_GROWTH=1 \
  -s MODULARIZE=1 \
  -s EXPORT_NAME=createCrackleModule \
  -s EXPORTED_FUNCTIONS='["_crackle_malloc","_crackle_free","_crackle_query","_crackle_compress","_crackle_decompress","_malloc","_free"]' \
  -s EXPORTED_RUNTIME_METHODS='["HEAPU8","HEAP32","getValue","setValue"]' \
  -o libcrackle.js \
  crackle_wasm.cc

echo "wrote libcrackle.js / libcrackle.wasm"
