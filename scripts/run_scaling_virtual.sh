#!/bin/bash
# Virtual-mesh scaling sweep: the four sharded paths x 1/2/4/8 devices on an
# 8-virtual-device CPU mesh (checks the meshes and collectives without GPUs;
# the times are labelled virtual). On a GPU host drop --virtual: one
# process drives every GPU. Prints one CSV on stdout.
set -e
cd "$(dirname "$0")/.."
PRESET="${1:-cavity10_like}"
first=1
for path in dia_halo ell_ring ell_rows csr_psum; do
  out=$(python -m spmv_openmp_cuda_tpu.bench.scaling \
        --preset "$PRESET" --devices 1 2 4 8 --path "$path" --virtual 8)
  if [ $first -eq 1 ]; then echo "$out"; first=0
  else echo "$out" | tail -n +2; fi
done
