"""Host utilities: configuration, events, the LRU dedup cache."""
