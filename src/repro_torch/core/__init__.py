"""The simulator's core: codecs, the Artemis round, problems, noise, sweep."""
