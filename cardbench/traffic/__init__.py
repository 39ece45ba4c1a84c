"""The benchmark's traffic: the frozen cluster wire (wire.py), the
general generator of the peers' delta streams (gen.py), the peers'
process (peer.py) and the open-loop RESP reader (loadgen.py). A traffic
mix is a JSON file here, found by the name BENCHMARK.json gives it."""
