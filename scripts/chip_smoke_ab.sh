# Run chip_smoke.py of two checkouts on one card in turns: A, B, B, A (a
# comparison is only fair inside one call, on one card).  Put either the
# parent or the change first, e.g.
#
#   git archive <parent-commit> | tar -x -C build/parent   # build/ is ignored
#   bash scripts/chip_smoke_ab.sh build/parent .
#
# Each run's full log goes to chiprun_out/ab_<label>.log (labels a1 b1 b2
# a2); the per-round walls and the serving times are printed.
set -u
a=${1:?usage: chip_smoke_ab.sh CHECKOUT_A CHECKOUT_B}
b=${2:?usage: chip_smoke_ab.sh CHECKOUT_A CHECKOUT_B}
out=$(pwd)/chiprun_out
mkdir -p "$out"
run() {  # $1 label, $2 checkout
  (cd "$2" && python3 chip_smoke.py) > "$out/ab_$1.log" 2>&1
  echo "== $1 ($2) rc=$?"
  grep -E "^path .*round=|^serve |^scenario highway.*round=" \
    "$out/ab_$1.log" | sed -E 's/launches=.*//' | cut -c1-220
}
run a1 "$a"
run b1 "$b"
run b2 "$b"
run a2 "$a"
