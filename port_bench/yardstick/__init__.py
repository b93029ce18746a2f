"""The benchmark's yardstick, frozen here so that no change to the program
moves it: the card's data-sheet peaks, the bytes and operations the two
compositing kernels need for given inputs, and the operations of a step's
stages counted from shapes."""
