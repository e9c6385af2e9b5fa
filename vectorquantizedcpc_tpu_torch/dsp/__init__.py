"""Host-side signal processing: mel, mu-law, BS.1770 loudness, wav I/O."""
