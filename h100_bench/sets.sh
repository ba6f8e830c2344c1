# usage: bash h100_bench/sets.sh <out dir> <seconds> <workload> <seed base> [<workload> <seed base> ...]
out=$1; sec=$2; shift 2
mkdir -p chiprun_out/$out
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
run() { w=$1; s=$2; tr=$3; tag=$4; t0=$(date +%s); python3 h100_bench/run.py --workload $w --seed $s --seconds $sec --trace $tr > chiprun_out/$out/$w.$tag.$s.$tr.out 2> chiprun_out/$out/$w.$tag.$s.$tr.err; rc=$?; echo "rc=$rc $w $tag $s $tr $(( $(date +%s) - t0 ))s $(grep '^setup' chiprun_out/$out/$w.$tag.$s.$tr.out | cut -c1-60)"; tail -n 1 chiprun_out/$out/$w.$tag.$s.$tr.out | cut -c1-420; echo; }
while [ $# -gt 0 ]; do
  w=$1; b=$2; shift 2
  for set in A B; do for i in 1 2 3 4 5 6; do run $w $((b + i)) 0 $set; done; done
  for i in 7 8 9; do run $w $((b + i)) 1 T; done
done
