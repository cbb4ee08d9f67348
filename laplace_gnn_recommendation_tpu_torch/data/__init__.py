"""Host-side data: graph containers, synthetic generators, splitting."""
