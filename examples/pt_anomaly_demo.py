"""The paper's read-only anomaly (Sec 3.3), executed four ways, on the
PyTorch/CUDA port (`repro_torch`).  The twin of `examples/anomaly_demo.py`:
for the same history its output is the reference's, line for line.

Shows h_s = R2(X0) R2(Y0) R1(Y0) W1(Y1) C1 [reader joins] W2(X2) C2 under:
  1. the history-level formalization (cycle T1 -> T3 -> T2 -> T1),
  2. plain SI        — accepts the anomaly (non-serializable!),
  3. SSI             — aborts a transaction (serializable, but costly),
  4. RSS             — the reader is steered to the PREVIOUS versions
                       (X0, Y0): serializable, nobody waits, nobody aborts.

    PYTHONPATH=src python examples/pt_anomaly_demo.py                # GPU
    PYTHONPATH=src python examples/pt_anomaly_demo.py --device cpu

The RSS facade (`SingleNodeHTAP`) takes the device; the anomaly itself is
host logic and runs the same on either.
"""

import argparse

from repro_torch.core import (construct_rss, find_cycle, is_serializable,
                              read_only_anomaly_example)
from repro_torch.mvcc import Engine, SerializationFailure, SingleNodeHTAP


def formal():
    h = read_only_anomaly_example()
    print("1) formal history:", h)
    print("   serializable?", is_serializable(h),
          "  cycle:", find_cycle(h))
    print("   (without the read-only T3 it IS serializable:",
          is_serializable(h.without_txn(3)), ")")


def under(mode: str):
    eng = Engine(mode, record=True)
    t2 = eng.begin()
    eng.read(t2, "X"), eng.read(t2, "Y")
    t1 = eng.begin()
    eng.read(t1, "Y")
    eng.write(t1, "Y", 20)
    eng.commit(t1)
    t3 = eng.begin(read_only=True)
    outcome = "committed all"
    try:
        x, y = eng.read(t3, "X"), eng.read(t3, "Y")
        eng.commit(t3)
        eng.write(t2, "X", -11)
        eng.commit(t2)
    except SerializationFailure as e:
        outcome = f"abort ({e.reason.value})"
        x = y = "-"
    print(f"   reader saw X={x} Y={y}; outcome: {outcome}; committed "
          f"history serializable? {is_serializable(eng.history)}")


def under_rss(device: str):
    htap = SingleNodeHTAP("ssi+rss", device=device)
    eng = htap.engine
    t2 = htap.oltp_begin()
    eng.read(t2, "X"), eng.read(t2, "Y")
    t1 = htap.oltp_begin()
    eng.read(t1, "Y")
    eng.write(t1, "Y", 20)
    eng.commit(t1)
    htap.refresh_rss()                 # T1 concurrent with active T2 -> NOT
    r = htap.olap_begin()              #   in RSS; reader gets previous Y
    x, y = htap.olap_read(r, "X"), htap.olap_read(r, "Y")
    htap.olap_commit(r)
    eng.write(t2, "X", -11)
    eng.commit(t2)
    print(f"   RSS reader saw X={x} Y={y} (previous versions) — no waits, "
          f"no aborts; writer T2 committed fine")
    if eng.history:
        construct_rss(eng.history)


def main(device: str = "cuda"):
    formal()
    print("2) plain SI (anomaly admitted):")
    under("si")
    print("3) SSI (serializable via abort):")
    under("ssi")
    print("4) RSS (serializable, wait-/abort-free — the paper):")
    under_rss(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
