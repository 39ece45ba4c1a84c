"""Startup banner (after jylis_tpu/utils/logo.py; reference analog:
logo.pony, printed by main.pony:12): one per node, none per lane."""

LOGO = r"""
     _       _ _            _
    (_)_   _| (_)___       | |_ _ __  _   _
    | | | | | | / __|_____ | __| '_ \| | | |
    | | |_| | | \__ \_____|| |_| |_) | |_| |
   _/ |\__, |_|_|___/       \__| .__/ \__,_|
  |__/ |___/                   |_|
        distributed CRDT database, PyTorch and CUDA
"""
