#!/usr/bin/env bash
# Run all nine examples of the port as modules (the reference's
# examples/run-all-scala.sh / run-all-pyspark.sh analog), from the
# repository root, all started together; each one's output is printed
# in turn when it ends. Arguments pass to every example: --device cpu
# runs them on the CPU (cuda, the card, by default). Any failure fails
# the script.
set -uo pipefail
cd "$(dirname "$0")/../.."

examples=(kmeans_example pca_example als_example
          kmeans_compat_example pca_compat_example als_compat_example
          kmeans_pyspark_example pca_pyspark_example als_pyspark_example)
logs="$(mktemp -d)"
trap 'rm -rf "$logs"' EXIT
pids=()
for ex in "${examples[@]}"; do
  python -m "oap_mllib_tpu_torch.examples.$ex" "$@" > "$logs/$ex.log" 2>&1 &
  pids+=($!)
done
failed=0
for i in "${!examples[@]}"; do
  ex="${examples[$i]}"
  status=0
  wait "${pids[$i]}" || status=$?
  echo "=== $ex ==="
  cat "$logs/$ex.log"
  if [ "$status" -ne 0 ]; then
    echo "FAILED: $ex exited $status"
    failed=1
  fi
  echo
done
if [ "$failed" -ne 0 ]; then
  exit 1
fi
echo "All examples completed."
