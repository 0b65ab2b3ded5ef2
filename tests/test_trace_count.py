"""tools/trace_count.py's HLO walk from the step's sort back to the fusion
that feeds it (the chop), on HLO text in the form XLA:GPU prints it."""

import pytest

from tools.trace_count import sort_input_fusion

# a radix-sort library call fed through a bitcast of one output of a
# multi-output fusion, as count_unique_fast compiles on an H100
CUB = """
  %input_reduce_select_fusion = (s64[]{:S(5)}, u64[250000,120]{1,0}) fusion(%p.1, %p.2), kind=kInput, calls=%fused_computation
  %get-tuple-element.6 = u64[250000,120]{1,0} get-tuple-element(%input_reduce_select_fusion), index=1, metadata={op_name="reduce_sum"}
  %bitcast.21 = u64[30000000]{0} bitcast(%get-tuple-element.6), metadata={op_name="select_n"}
  %custom-call.1 = (u64[30000000]{0}, u8[245350911]{0}) custom-call(%bitcast.21), custom_call_target="__cub$DeviceRadixSort"
"""

# a sort instruction fed straight by a fusion
PLAIN = """
  %loop_select_fusion = u64[1200]{0} fusion(%p.1), kind=kLoop, calls=%fused_computation.1
  %sort.3 = u64[1200]{0} sort(%loop_select_fusion), dimensions={0}, to_apply=%compare
"""


@pytest.mark.parametrize("hlo,want", [
    (CUB, "input_reduce_select_fusion"),
    (PLAIN, "loop_select_fusion"),
    ("  %add.1 = u64[4]{0} add(%p.1, %p.2)\n", None),
], ids=["cub_through_gte", "sort_of_fusion", "no_sort"])
def test_sort_input_fusion(hlo, want):
    assert sort_input_fusion(hlo) == want
