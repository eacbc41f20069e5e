"""Host helpers, dtype/device policy and timing."""
