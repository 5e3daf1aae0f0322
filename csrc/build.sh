#!/bin/sh
# Build the native panel decoder shared library:
#   sh csrc/build.sh [OUT]     (default OUT: build/libgauss_panel.so)
# gauss_jax.io.native runs this at first use.
set -e
src="$(cd "$(dirname "$0")" && pwd)"
out="${1:-$src/../build/libgauss_panel.so}"
mkdir -p "$(dirname "$out")"
tmp="$out.tmp.$$"
g++ -O3 -std=c++17 -shared -fPIC "$src/panel_decoder.cpp" -o "$tmp" -lz -lpthread
mv -f "$tmp" "$out"
echo "built $out"
