# Two sets of 6 runs of one cell with the same seeds in both, after 3 traced runs (the first
# builds the kernels), as the bounds in BENCHMARK.json were measured. One JSON line a run
# in $OUT/sets_<cell>.jsonl (default chiprun_out/), stderr under $OUT/err_<cell>/.
#   bash h100_bench/sets.sh <cell> <seconds> <first traced seed> <first set seed>
cell=$1; secs=$2; st=$3; ss=$4
OUT=${OUT:-chiprun_out}; out=$OUT/sets_$cell.jsonl; errd=$OUT/err_$cell; mkdir -p $errd
one() { # label seed trace
  t0=$(date +%s.%N)
  python3 h100_bench/run.py --workload $cell --seed $2 --seconds $secs --trace $3 > $errd/$1.out 2> $errd/$1.err
  rc=$?; t1=$(date +%s.%N)
  line=$(tail -n 1 $errd/$1.out)
  echo "{\"label\": \"$1\", \"seed\": $2, \"trace\": $3, \"rc\": $rc, \"wall_s\": $(python3 -c "print($t1 - $t0)"), \"line\": ${line:-null}}" >> $out
  echo "$1 rc=$rc"; grep -E "^(set-up|window|reference|check)" $errd/$1.err | cut -c1-300
}
for i in 0 1 2; do one trace$i $((st + i)) 1; done
for set in A B; do for i in 0 1 2 3 4 5; do one ${set}$i $((ss + i)) 0; done; done
